"""K8's plain versions at the head widths 24 and 12: d_model 384 in 16
heads of 24 and in 32 heads of 12, against the JAX package on the CPU
(K6 / K7 and one SST block there: ``test_torch_port_narrow_heads_qkv.py``,
so that each file stays under 40 s alone).

At D = 24 and 12 the scale 1/sqrt(D) is no power of two, so both
packages multiply the f32 score by it (JAX's ``_scale_pow2`` is false);
the bf16 kernels run D = 12 over 16-channel slots whose last 4 channels
are zero, and their plain twins here keep the kernels' order over the
head's own 12 (zeros change no sum).  K8 (``ops/attention.py``): the
plain forward and its statistics against ``band_attention_pallas``'s
``_pallas_forward`` in interpret mode, V 128, and the plain backward
against the vjp of the JAX einsum route (JAX's own ``_pallas_backward``
takes at most 10 heads, R6), through
``test_torch_port_head_widths.k8_case``; the bf16 kernels' plain twins
(``band_attention_tiles_plain``, the forward's 64-token tiles and 64-key
chunks, and ``band_attention_backward_tiles_plain`` at the kernel's
64-token tiles and 64-row chunks) against the plain versions on windows
of 1 to 300 tokens; the D prologue's twin against the JAX einsum.  One
interpret-mode comparison a dtype (JAX traces its kernels head by head):
K8 in f32 at 16 heads and in bf16 at 32 (K6 / K7 the other way), so that
each head width meets both dtypes.

Tolerances: f32 2e-5 + 2e-4 relative, the statistics 1e-5; bf16 2e-2 +
2e-2 relative with atol times each row's max(1, largest |ref|) (both
packages round at the same points; sums in another order may move a
rounding to the other side); the tile twins against the plain versions
in f32 at 1e-5 of the largest value (the same terms summed in another
order), the bf16 forward twin at the bf16 rule (p rounded against
another max); the prologue at (D - 1) 2^-24 sum |terms| (D exact f32
products added in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu_torch.models.sst import attention_route
from geomae_tpu_torch.ops import attention
from test_torch_port_band_ops import DTYPES, assert_rows_close, sized_windows
from test_torch_port_head_widths import k8_case

INT_MAX = np.iinfo(np.int32).max
WIDTHS = [(384, 16), (384, 32)]      # (C, heads): D 24 and 12
IDS = ["384in16", "384in32"]
# The interpret-mode comparisons, one a dtype, so that each head width
# meets both dtypes with K6 / K7's (``test_torch_port_narrow_heads_qkv``):
# K8 in f32 at D 24, in bf16 at D 12
K8_CASES = [(384, 16, "f32"), (384, 32, "bf16")]


def case_ids(cases):
    return [f"{c}in{h}-{d}" for c, h, d in cases]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("C,H", WIDTHS, ids=IDS)
def test_narrow_heads_take_the_kernels(C, H):
    """The width gate admits both widths, and every attention name
    resolves to a kernel route there; the bf16 backward takes 64-row
    chunks; the same head width at C 768 stays outside."""
    assert attention.kernel_takes(C, H) and (C, C // H) in \
        attention.kernel_widths()
    assert [attention_route(i, C, H) for i in ("auto", "band", "qkv")] \
        == ["band", "band", "qkv"]
    assert attention.backward_chunk(C // H) == attention.KERNEL_TILE
    assert not attention.kernel_takes(768, 768 // (C // H))
    assert attention_route("band", 768, 768 // (C // H)) == "einsum"


@pytest.mark.parametrize("C,H,dtype", K8_CASES, ids=case_ids(K8_CASES))
def test_k8_forward_and_statistics_at_narrow_heads(C, H, dtype):
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


@pytest.mark.parametrize("C,H,dtype", K8_CASES, ids=case_ids(K8_CASES))
def test_k8_backward_at_narrow_heads(C, H, dtype):
    """The plain backward against the vjp of the JAX einsum route in f32
    on the same values (16 and 32 heads are past R6's 10), with a window
    whose keys are all invalid, per row; padding rows 0."""
    (tq, tk, tv, tw, tkv, tg), (_, _, want) = k8_case(H, C // H, dtype)
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


@pytest.mark.parametrize("C,H", WIDTHS, ids=IDS)
def test_k8_tile_twins_at_narrow_heads(C, H):
    """The bf16 kernels' orders in plain PyTorch on windows of 1 to 300
    tokens (one of them without a valid key): the forward twin against
    ``band_attention`` in f32 and in bf16, its lse against
    ``band_attention_lse_plain`` at 1e-5 where a row sees a key; the
    backward twin at the kernel's tiling (64-token tiles as queries and
    keys, 64-row chunks) against the plain backward in f32; padding rows
    and the keyless window's dq 0."""
    q, k, v, win, kv, g, keyless = sized_windows(
        np.random.default_rng(C + H), H=H, D=C // H)
    t = torch.from_numpy
    lse, plain = {}, {}
    for dtype in DTYPES:
        tdt = DTYPES[dtype][1]
        args = [t(a).to(tdt) for a in (q, k, v)] + [t(win), t(kv)]
        out, lse[dtype] = attention.band_attention_tiles_plain(*args)
        plain[dtype] = attention.band_attention(*args)
        assert out.dtype == tdt
        assert_rows_close(out.float().flatten(2).numpy(),
                          plain[dtype].float().flatten(2).numpy(), dtype)
    lse = lse["f32"]
    args = [t(a) for a in (q, k, v, win, kv)]
    want_lse = attention.band_attention_lse_plain(args[0], args[1],
                                                  *args[3:])
    seen = want_lse != 0
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=0, atol=1e-5)
    assert (lse[~seen] == 0).all()
    out = plain["f32"]
    got = attention.band_attention_backward_tiles_plain(*args, out, want_lse,
                                                        t(g))
    want = attention.band_attention_backward_plain(*args, out, t(g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    pad = t(win == INT_MAX)
    assert pad.any() and all((a[pad] == 0).all() for a in got)
    assert (got[0][t(keyless)] == 0).all()


@pytest.mark.parametrize("C,H", WIDTHS, ids=IDS)
def test_k8_delta_at_narrow_heads(C, H):
    """D = rowsum(g * out) per (row, head) on bf16 inputs against the JAX
    package's ``einsum(..., preferred_element_type=f32)``: every product
    is exact in f32, so only the order of D f32 additions differs; 0 on
    the padding rows."""
    D = C // H
    rng = np.random.default_rng(C + D)
    g, out = (rng.normal(size=(2, 200, H, D)).astype(np.float32)
              for _ in range(2))
    jg, jo = (jnp.asarray(a, jnp.bfloat16) for a in (g, out))
    want = np.asarray(jnp.einsum("bvhd,bvhd->bvh", jg, jo,
                                 preferred_element_type=jnp.float32))
    tg, to = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (jg, jo))
    win = torch.zeros(2, 200, dtype=torch.int32)
    win[1, 120:] = INT_MAX                   # a padding suffix
    real = (win != INT_MAX).numpy()
    got = attention.band_attention_delta_plain(to, tg, win)
    assert got.dtype == torch.float32 and got.shape == want.shape
    mag = attention.band_attention_delta_plain(to.abs(), tg.abs(),
                                               win).numpy()
    err = np.abs(got.numpy() - want)
    assert (err[real] <= (D - 1) * 2.0 ** -24 * mag[real]).all()
    assert (got.numpy()[~real] == 0).all() and (mag[real] > 0).all()
