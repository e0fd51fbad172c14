"""K5's plain versions and one SST block at d_model 640, 768 and 1024,
against the JAX package on the CPU.

K5 (``ops/ffn.py``) at (C, F) = (640, 640), (768, 3072) and (1024,
2048): the first keeps both F-wide rows of a 16-token tile in the bf16
tile pass, the other two stream them 128 columns a pass
(``csrc/post_attention.cuh``, ``Widths::kNoHiddenRow``), whose sums add
their terms in the stage order, so ``post_attention_block_backward_
tile_plain`` stays the pass's plain twin.  The plain forward and
backward against ``post_attention_block`` and ``_backward`` in interpret
mode (``test_torch_port_ffn_widths.k5_case`` and its checks: f32 1e-5,
the parameter gradients at 1e-5 of each one's largest value; bf16 2e-2 +
2e-2 relative with atol times each row's max(1, largest |ref|), the f32
parameter gradients at 2e-2 of their largest value).  One SST block at C
768 in 12 heads of 64, FFN 3072, on the port's band / fused route (K8
and K5: their plain versions here) from ``from_flax`` of the JAX stack's
weights, against the JAX stack's Pallas routes in interpret mode."""
import pytest
import torch

from test_torch_port_band_ops import (DTYPES, check_route_against_pallas,
                                      stack_case)
from test_torch_port_ffn_widths import check_k5_backward, check_k5_forward

K5_WIDTHS = [(640, 640), (768, 3072), (1024, 2048)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", K5_WIDTHS)
def test_k5_forward_at_wide_channels(C, F, dtype):
    """``check_k5_forward`` at F of C at C 640, 4 C at 768, 2 C at 1024."""
    check_k5_forward(C, F, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", K5_WIDTHS)
def test_k5_backward_at_wide_channels(C, F, dtype):
    """``check_k5_backward`` at F of C at C 640, 4 C at 768, 2 C at
    1024."""
    check_k5_backward(C, F, dtype)


def test_sst_block_at_768_matches_the_jax_pallas_routes():
    """One block at C 768 in 12 heads of 64, FFN 3072, V 128: the port's
    band / fused route (which ``check_route_against_pallas`` asserts it
    resolves to) against the JAX stack's band / fused route in interpret
    mode, 1e-4 on the valid rows."""
    check_route_against_pallas(stack_case((768, 12, 3072), V=128,
                                          grads=False))
