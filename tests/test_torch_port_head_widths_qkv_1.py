"""K6 / K7's plain versions at (C, H) = (256, 32) and (128, 1), and one
SST block at C 128 in one head of 128, against the JAX package on the
CPU (K8's at the head widths 8 and 128, and ``check_k7_at_head_width``:
``test_torch_port_head_widths.py``; the other two widths and block:
``test_torch_port_head_widths_qkv_16.py``, so that each file stays under
40 s alone).

At D = 8 and 128 the scale 1/sqrt(D) is no power of two, so it
multiplies the f32 score in both packages.  K6 / K7
(``ops/attention_qkv.py``, the ``qkv`` route) against
``band_attention_qkv``'s ``_pallas_forward`` /
``_pallas_backward_merged`` in interpret mode at V 256 (JAX's qkv route
takes every head count), the forward through
``test_torch_port_qkv_widths.py``'s check, the backward through
``check_k7_at_head_width``: f32 2e-5 + 2e-4 relative, the statistics
1e-5; bf16 2e-2 + 2e-2 relative with atol times each row's max(1,
largest |ref|); the qkv parameter gradients at 2e-5 (f32) or 2e-2
(bf16) of max(their own largest value, 1e-2 of the largest of the six),
the key bias's by F3's bound in both dtypes.  The block on the port's
``band`` and ``qkv`` routes (with ``fused``) against the JAX stack's
Pallas routes in interpret mode, from ``from_flax`` of its weights."""
import functools

import pytest
import torch

import test_torch_port_qkv_widths as qkv_widths
from test_torch_port_band_ops import DTYPES, check_route_against_pallas, \
    stack_case
from test_torch_port_head_widths import check_k7_at_head_width

# (C, heads): D 8 at C 256, D 128 at C 128
HEAD_WIDTHS = [(256, 32), (128, 1)]
WIDTH_IDS = [f"{c}in{h}" for c, h in HEAD_WIDTHS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", HEAD_WIDTHS, ids=WIDTH_IDS)
def test_k6_forward_and_statistics_at_head_width(C, H, dtype):
    """The plain K6 against ``_pallas_forward`` in interpret mode, V 256;
    f32 statistics at 1e-5."""
    qkv_widths.test_k6_forward_and_statistics_at_width(C, H, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", HEAD_WIDTHS, ids=WIDTH_IDS)
def test_k7_backward_at_head_width(C, H, dtype):
    """``check_k7_at_head_width``: the plain K7 against the interpret-mode
    ``_pallas_backward_merged``, dx per row, the parameter gradients, the
    key bias's by F3's bound."""
    check_k7_at_head_width(C, H, dtype)


@functools.lru_cache(maxsize=None)
def block_case(heads):
    """``stack_case`` at C 128 in ``heads`` heads, FFN 256, V 128, once for
    the file."""
    return stack_case((128, heads, 256), V=128, grads=False)


@pytest.mark.parametrize("route", ["band", "qkv"])
@pytest.mark.parametrize("heads", [1], ids=["1x128"])
def test_sst_block_at_head_width_matches_the_jax_pallas_routes(heads, route):
    """One block at C 128 in one head of 128, FFN 256, V 128, on the port's
    ``route`` / fused route (K8 or K6, and K5: their plain versions here)
    against the JAX stack's on the same routes in interpret mode, 1e-4 on
    the valid rows."""
    check_route_against_pallas(block_case(heads), route)
