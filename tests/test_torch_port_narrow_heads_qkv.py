"""K6 / K7's plain versions and one SST block at the head widths 24 and
12: d_model 384 in 16 heads of 24 and in 32 heads of 12, against the JAX
package on the CPU (K8's: ``test_torch_port_narrow_heads.py``).

At D = 24 and 12 the scale 1/sqrt(D) is no power of two, so both
packages multiply the f32 score by it (JAX's ``_scale_pow2`` is false).
K6 / K7 (``ops/attention_qkv.py``, the ``qkv`` route) against
``band_attention_qkv``'s ``_pallas_forward`` / ``_pallas_backward_merged``
in interpret mode at V 256, through ``test_torch_port_qkv_widths``'
checks, one comparison a dtype (JAX traces its kernels head by head): in
f32 at 32 heads and in bf16 at 16 (K8 the other way), so that each head
width meets both dtypes.

Tolerances: f32 2e-5 + 2e-4 relative, the statistics 1e-5; bf16 2e-2 +
2e-2 relative with atol times each row's max(1, largest |ref|) (both
packages round at the same points; sums in another order may move a
rounding to the other side); K7's parameter gradients at 2e-5 (f32) or
2e-2 (bf16) of max(their own largest value, 1e-2 of the largest of the
six), the key bias's by F3's bound at the dtype's unit roundoff
(``check_k7_backward``).  Then one SST block at (384, 16, 768) on the
port's ``band`` and ``qkv`` routes (with ``fused``), from ``from_flax``
of the JAX stack's weights, against the JAX stack on the same routes with
its Pallas kernels in interpret mode, 1e-4 on the valid rows."""
import pytest
import torch

from test_torch_port_band_ops import check_route_against_pallas, stack_case
from test_torch_port_qkv_widths import check_k6_forward, check_k7_backward

# K6 / K7 in f32 at D 12, in bf16 at D 24
QKV_CASES = [(384, 32, "f32"), (384, 16, "bf16")]


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
def test_k6_forward_and_statistics_at_narrow_heads(C, H, dtype):
    """``check_k6_forward`` at 32 heads of 12 (f32) and 16 of 24
    (bf16)."""
    check_k6_forward(C, H, dtype)


@pytest.mark.parametrize("C,H,dtype", QKV_CASES, ids=case_ids(QKV_CASES))
def test_k7_backward_at_narrow_heads(C, H, dtype):
    """``check_k7_backward`` at 32 heads of 12 (f32) and 16 of 24
    (bf16)."""
    check_k7_backward(C, H, dtype)


@pytest.fixture(scope="module")
def block():
    return stack_case((384, 16, 768), V=128, grads=False)


@pytest.mark.parametrize("route", ["band", "qkv"])
def test_sst_block_at_384_in_16_heads_matches_the_jax_pallas_routes(block,
                                                                    route):
    """One block at C 384 in 16 heads of 24, FFN 768, V 128: the port's
    ``route`` / fused route (which ``check_route_against_pallas`` asserts
    it resolves to: K8 or K6, and K5; their plain versions here) against
    the JAX stack on the same routes in interpret mode, 1e-4 on the valid
    rows."""
    check_route_against_pallas(block, route)
