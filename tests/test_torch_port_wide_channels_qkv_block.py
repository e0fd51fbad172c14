"""K6 / K7's plain versions at d_model 1024 and one SST block on the
``qkv`` route at d_model 768, against the JAX package on the CPU (K6 /
K7 at 640 and 768 and the route's gate:
``test_torch_port_wide_channels_qkv.py``, so that each file stays under
40 s alone).

K6 and K7 (``ops/attention_qkv.py``) at (C, heads) = (1024, 16), D 64
(the scale folded into q): the plain forward and its statistics against
``band_attention_qkv``'s ``_pallas_forward`` and the plain backward
against ``_pallas_backward_merged`` in interpret mode (JAX's qkv
backward takes any head count; its K8 backward refuses 16 heads), V
256, through ``test_torch_port_qkv_widths``' inputs and checks, at the
rules of ``test_torch_port_head_widths_qkv_16.py``: f32 2e-5 + 2e-4
relative, the statistics 1e-5; bf16 2e-2 + 2e-2 relative with atol
times each row's max(1, largest |ref|); the parameter gradients at 2e-5
(f32) or 2e-2 (bf16) of max(their own largest value, 1e-2 of the largest
of the six), the key bias's by F3's rule at the dtype's unit roundoff
(``probe_qkv.dbk_bound``).  One SST block at C 768 in 12 heads of 64,
FFN 3072, on the port's ``qkv`` / ``fused`` route (K6 and K5: their
plain versions here) from ``from_flax`` of the JAX stack's weights,
against the JAX stack on its ``qkv`` / ``fused`` route in interpret
mode."""
import pytest
import torch

from test_torch_port_band_ops import (DTYPES, check_route_against_pallas,
                                      stack_case)
from test_torch_port_qkv_widths import check_k6_forward, check_k7_backward

WIDTHS = [(1024, 16)]       # (C, heads): D 64
WIDTH_IDS = [f"{c}in{h}" for c, h in WIDTHS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=WIDTH_IDS)
def test_k6_forward_and_statistics_at_1024(C, H, dtype):
    """``check_k6_forward`` at (1024, 16)."""
    check_k6_forward(C, H, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=WIDTH_IDS)
def test_k7_backward_at_1024(C, H, dtype):
    """``check_k7_backward`` at (1024, 16)."""
    check_k7_backward(C, H, dtype)


def test_sst_block_at_768_matches_the_jax_qkv_route():
    """One block at C 768 in 12 heads of 64, FFN 3072, V 128: the port's
    qkv / fused route (which ``check_route_against_pallas`` asserts it
    resolves to) against the JAX stack's qkv / fused route in interpret
    mode, 1e-4 on the valid rows."""
    check_route_against_pallas(stack_case((768, 12, 3072), V=128,
                                          grads=False), "qkv")
