"""K6 / K7's plain versions on the ``qkv`` route at d_model 640 and 768,
and the route's gate at 640, 768 and 1024, against the JAX package on
the CPU (K6 / K7 at 1024 and one qkv block at 768:
``test_torch_port_wide_channels_qkv_block.py``, so that each file stays
under 40 s alone).

K6 and K7 (``ops/attention_qkv.py``) at (C, heads) = (640, 10) and
(768, 6), D 64 and 128 (the scale folded into q at D 64, on the f32
score at D 128): the plain forward and its statistics against
``band_attention_qkv``'s ``_pallas_forward`` and the plain backward
against ``_pallas_backward_merged`` in interpret mode (JAX's qkv
backward takes any head count), V 256, through
``test_torch_port_qkv_widths``' inputs and checks (``jax_case``,
``check_k6_forward``, ``check_k7_backward``), at the rules of
``test_torch_port_head_widths_qkv_16.py``: f32 2e-5 + 2e-4 relative, the
statistics 1e-5; bf16 2e-2 + 2e-2 relative with atol times each row's
max(1, largest |ref|); the parameter gradients at 2e-5 (f32) or 2e-2
(bf16) of max(their own largest value, 1e-2 of the largest of the six),
the key bias's by F3's rule at the dtype's unit roundoff
(``probe_qkv.dbk_bound``).  The gate at each C: ``qkv`` resolves to
itself in heads of 8 to 128 and to the plain route in heads of 4, of
256 and in one head."""
import pytest
import torch

from geomae_tpu_torch.models.sst import attention_route
from geomae_tpu_torch.ops import attention_qkv
from test_torch_port_band_ops import DTYPES
from test_torch_port_qkv_widths import check_k6_forward, check_k7_backward

# (C, heads): D 64 at C 640, D 128 at C 768
WIDTHS = [(640, 10), (768, 6)]
WIDTH_IDS = [f"{c}in{h}" for c, h in WIDTHS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("C", [640, 768, 1024])
def test_qkv_gate_at_wide_channels(C):
    """K6 and K7 take heads of 8, 16, 32, 64 and 128 channels at C (the
    projections, which see no heads, take C), where ``qkv`` resolves to
    itself, and neither heads of 4 nor of 256 nor one head of C, where
    it resolves to the plain route."""
    assert C in attention_qkv.KERNEL_CHANNELS
    for D in (8, 16, 32, 64, 128):
        assert attention_qkv.kernel_takes(C, C // D)
        assert attention_route("qkv", C, C // D) == "qkv"
    for D in (4, 256, C):
        if C % D == 0:
            assert not attention_qkv.kernel_takes(C, C // D)
            assert attention_route("qkv", C, C // D) == "einsum"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=WIDTH_IDS)
def test_k6_forward_and_statistics_at_wide_channels(C, H, dtype):
    """``check_k6_forward`` at (640, 10) and (768, 6)."""
    check_k6_forward(C, H, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=WIDTH_IDS)
def test_k7_backward_at_wide_channels(C, H, dtype):
    """``check_k7_backward`` at (640, 10) and (768, 6)."""
    check_k7_backward(C, H, dtype)
