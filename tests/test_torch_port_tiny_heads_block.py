"""One SST block at the shipped d_model 128 in 32 heads of 4, FFN 256,
on the port's ``band`` and ``qkv`` routes (with ``fused``), from
``from_flax`` of the JAX stack's weights, against the JAX stack on the
same routes with its Pallas kernels in interpret mode, 1e-4 on the valid
rows (K8's and K6 / K7's plain versions at the heads below 8:
``test_torch_port_tiny_heads*.py``).  Forward only: JAX's own K8
backward takes at most 10 heads (R6)."""
import pytest
import torch

from test_torch_port_band_ops import check_route_against_pallas, stack_case


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    return stack_case((128, 32, 256), V=128, grads=False)


@pytest.mark.parametrize("route", ["band", "qkv"])
def test_sst_block_at_128_in_32_heads_matches_the_jax_pallas_routes(block,
                                                                    route):
    """One block at C 128 in 32 heads of 4, FFN 256, V 128: the port's
    ``route`` / fused route (which ``check_route_against_pallas`` asserts
    it resolves to: K8 or K6, and K5; their plain versions here) against
    the JAX stack on the same routes in interpret mode, 1e-4 on the valid
    rows."""
    check_route_against_pallas(block, route)
