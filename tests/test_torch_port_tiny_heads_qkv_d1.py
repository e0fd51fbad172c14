"""K6 / K7's plain versions at d_model 128 in 128 heads of 1, against
the JAX package on the CPU (K8's: ``test_torch_port_tiny_heads.py``; one
SST block: ``test_torch_port_tiny_heads_block.py``; the other heads
below 8: ``test_torch_port_tiny_heads_qkv_*.py``, one or two widths a
file, so that each file stays under 40 s alone: JAX traces its
interpret-mode kernels head by head, about 24 s at 128 heads).

K6 / K7 (``ops/attention_qkv.py``, the ``qkv`` route) against
``band_attention_qkv``'s ``_pallas_forward`` /
``_pallas_backward_merged`` in interpret mode at V 256, through
``test_torch_port_qkv_widths``' checks, at the smallest head count that
gives each head width, one comparison a width, the dtypes alternating
over the five widths (f32 at D 4, 6 and 1, bf16 at D 2 and 3). At D = 1
the scale 1/sqrt(D) is 1, a power of four, so both packages fold it into
q (JAX's ``_scale_pow2``).

Tolerances: f32 2e-5 + 2e-4 relative, the statistics 1e-5; bf16 2e-2 +
2e-2 relative with atol times each row's max(1, largest |ref|); K7's
parameter gradients at 2e-5 (f32) or 2e-2 (bf16) of max(their own
largest value, 1e-2 of the largest of the six), the key bias's by F3's
bound at the dtype's unit roundoff (``check_k7_backward``)."""
import pytest
import torch

from test_torch_port_qkv_widths import check_k6_forward, check_k7_backward

# (C, heads, dtype): D 1 in f32
QKV_CASES = [(128, 128, "f32")]


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


@pytest.mark.parametrize("C,H,dtype", QKV_CASES, ids=case_ids(QKV_CASES))
def test_k6_forward_and_statistics_at_tiny_heads(C, H, dtype):
    """``check_k6_forward`` at 128 heads of 1 (f32)."""
    check_k6_forward(C, H, dtype)


@pytest.mark.parametrize("C,H,dtype", QKV_CASES, ids=case_ids(QKV_CASES))
def test_k7_backward_at_tiny_heads(C, H, dtype):
    """``check_k7_backward`` at 128 heads of 1 (f32)."""
    check_k7_backward(C, H, dtype)
