"""K6 and K7 (``ops/attention_qkv.py``, the ``qkv`` route) at d_model 384
and 512, against the JAX package on the CPU.

The plain forward, its statistics and its backward (dx and the six
parameter gradients) against ``band_attention_qkv``'s ``_pallas_forward``
and ``_pallas_backward_merged`` in interpret mode at (C, H, D) = (384,
12, 32), where the scale multiplies the f32 score, and (512, 8, 64),
where it folds into q (D a power of four), f32 and bf16, V = 256, tile
64, pad 128, through ``test_torch_port_qkv_widths``' inputs and checks
(``jax_case``, ``check_k6_forward``, ``check_k7_backward``): f32 2e-5 +
2e-4 relative, the statistics 1e-5; bf16 2e-2 + 2e-2 relative with atol
times each row's max(1, largest |ref|); the parameter gradients at 2e-5
(f32) or 2e-2 (bf16) of max(their own largest value, 1e-2 of the largest
of the six), the key bias's by F3's rule at the dtype's unit roundoff
(``probe_qkv.dbk_bound``).
Then one SST block at C 384 in 12 heads of 32, FFN 768, on the port's
``qkv`` / ``fused`` route (K6 and K5: their plain versions here) from
``from_flax`` of the JAX stack's weights, against the JAX stack on its
``qkv`` / ``fused`` route in interpret mode."""
import pytest
import torch

from test_torch_port_band_ops import (DTYPES, check_route_against_pallas,
                                      stack_case)
from test_torch_port_qkv_widths import check_k6_forward, check_k7_backward

WIDTHS = [(384, 12), (512, 8)]     # (C, heads): D 32, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=lambda w: str(w))
def test_k6_forward_and_statistics_at_channel_width(C, H, dtype):
    """``check_k6_forward`` at (384, 12) and (512, 8)."""
    check_k6_forward(C, H, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=lambda w: str(w))
def test_k7_backward_at_channel_width(C, H, dtype):
    """``check_k7_backward`` at (384, 12) and (512, 8)."""
    check_k7_backward(C, H, dtype)


def test_sst_block_at_384_matches_the_jax_qkv_route():
    """One block at C 384 in 12 heads of 32, FFN 768, V 128: the port's
    qkv / fused route (which ``check_route_against_pallas`` asserts it
    resolves to) against the JAX stack's qkv / fused route in interpret
    mode, 1e-4 on the valid rows."""
    check_route_against_pallas(stack_case((384, 12, 768), V=128,
                                          grads=False), "qkv")
