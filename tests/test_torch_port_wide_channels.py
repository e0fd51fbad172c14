"""K8's plain versions at d_model 640, 768 and 1024, against the JAX
package on the CPU.

K8 (``ops/attention.py``) at (C, heads) = (640, 10) and (768, 6), D 64
and 128: the plain forward and its statistics against
``_pallas_forward`` in interpret mode and the plain backward against
``_pallas_backward``, V 128; at (768, 12) and (1024, 16) (D 64) JAX's
backward refuses the head count (R6, more than 10 heads), so there the
plain backward is held to the vjp of the JAX einsum route in f32 on the
same values (``test_torch_port_head_widths.k8_case``, whose JAX results,
once a width, this file shares).  The rules are
``test_torch_port_widths.py``'s: f32 2e-5 + 2e-4 relative, the
statistics 1e-5; bf16 2e-2 + 2e-2 relative with atol times each row's
max(1, largest |ref|).  The gate admits the five head widths of each C
on both kernel routes and refuses the others there.  K5 and one SST
block at these widths are in ``test_torch_port_wide_channels_ffn.py``,
K6 / K7 and a qkv block in ``test_torch_port_wide_channels_qkv.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu_torch.models.sst import attention_route
from geomae_tpu_torch.ops import attention, attention_qkv
from test_torch_port_band_ops import DTYPES, assert_rows_close
from test_torch_port_head_widths import k8_case

INT_MAX = np.iinfo(np.int32).max
# (C, heads): D 64 at C 640 and D 128 at C 768, where JAX's own K8
# backward takes the head count; D 64 at C 768 and 1024 (12 and 16
# heads), where it does not
K8_WIDTHS = [(640, 10), (768, 6)]
K8_BACKWARD_WIDTHS = K8_WIDTHS + [(768, 12), (1024, 16)]


def ids(widths):
    return [f"{c}in{h}" for c, h in widths]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("C", [640, 768, 1024])
def test_wide_channels_take_heads_of_8_to_128(C):
    """At C 640, 768 and 1024 the gate takes heads of 8, 16, 32, 64 and
    128 channels on the band route and on K6 / K7's (``qkv`` resolves to
    itself), and no other head width: heads of 4, of 256 and one head of
    C."""
    takes = [D for D in attention.KERNEL_HEAD_DIMS + (C,)
             if C % D == 0 and attention.kernel_takes(C, C // D)]
    assert takes == [8, 16, 32, 64, 128]
    for D in takes:
        assert (C, D) in attention.kernel_widths()
        assert attention_qkv.kernel_takes(C, C // D)
        assert [attention_route(i, C, C // D) for i in ("auto", "band",
                                                        "qkv")] == \
            ["band", "band", "qkv"]
    for D in (4, 256, C):
        if C % D == 0:
            assert attention_route("band", C, C // D) == "einsum"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", K8_WIDTHS, ids=ids(K8_WIDTHS))
def test_k8_forward_and_statistics_at_wide_channels(C, H, dtype):
    """The plain forward against ``_pallas_forward`` in interpret mode on
    the real rows, padding rows 0; f32 statistics (m + log l where a row
    sees a key) at 1e-5, 0 elsewhere."""
    (tq, tk, tv, tw, tkv, _), (want, stats, _) = k8_case(H, C // H, dtype)
    assert tq.shape[2:] == (H, C // H)
    got = attention.band_attention(tq, tk, tv, tw, tkv)
    assert got.dtype == DTYPES[dtype][1]
    real = (tw != INT_MAX).numpy()
    assert_rows_close(got.float().numpy()[real],
                      np.asarray(want.astype(jnp.float32))[real], dtype)
    assert (got.float().numpy()[~real] == 0).all()
    if dtype == "f32":
        m, l = stats[..., :H], stats[..., H:]
        lse = attention.band_attention_lse_plain(tq, tk, tw, tkv).numpy()
        seen = l > 0
        assert seen.any() and (~seen & real[..., None]).any()
        np.testing.assert_allclose(
            lse[seen], (m + np.log(np.where(seen, l, 1)))[seen], rtol=0,
            atol=1e-5)
        assert (lse[~seen] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", K8_BACKWARD_WIDTHS,
                         ids=ids(K8_BACKWARD_WIDTHS))
def test_k8_backward_at_wide_channels(C, H, dtype):
    """The plain backward against ``k8_case``'s reference backward (JAX's
    ``_pallas_backward`` from its kernel's forward, at 12 and 16 heads
    the vjp of the einsum route), with a window whose keys are all
    invalid, per row; padding rows 0."""
    case = k8_case(H, C // H, dtype) if (C, H) in K8_WIDTHS else \
        k8_case(H, C // H, dtype, forward=False)
    (tq, tk, tv, tw, tkv, tg), (_, _, want) = case
    out = attention.band_attention(tq, tk, tv, tw, tkv)
    got = attention.band_attention_backward_plain(tq, tk, tv, tw, tkv, out,
                                                  tg)
    pad = (tw[0] == INT_MAX).numpy()
    for a, w in zip(got, want):
        assert a.dtype == DTYPES[dtype][1] and a.shape[2:] == (H, C // H)
        a = a.float().numpy()
        assert_rows_close(a.reshape(*a.shape[:2], -1),
                          np.asarray(w.astype(jnp.float32)).reshape(
                              *a.shape[:2], -1), dtype)
        assert pad.any() and (a[0, pad] == 0).all()
