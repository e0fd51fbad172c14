"""K5 (``ops/ffn.py``) at FFN widths of 1 and 3 times C against the JAX
package on the CPU: (C, F) = (128, 128), (128, 384), (256, 256) and
(256, 768), beside the 2 C and 4 C of ``test_torch_port_widths.py``,
which holds its K5 cases by this file's ``check_k5_forward`` and
``check_k5_backward``.

The plain forward and backward against ``post_attention_block`` and
``_backward`` in interpret mode, V = 128 with ``nv`` short of V in the
first sample: f32 at 1e-5, the parameter gradients at 1e-5 of each one's
largest value; bf16 per row at 2e-2 + 2e-2 relative, atol times each
row's max(1, largest |ref|) (both round at the same points; f32 sums in
another order may move a rounding to the other side), its f32 parameter
gradients at 2e-2 of their largest value.  Each width's JAX results are
computed once for the file, forward and backward in one ``jax.jit``
(``k5_case``).  One SST block at C = 128 in 8 heads of 16 with FFN 384
on the port's band / fused route (K8, K5: their plain versions here),
from ``from_flax`` of the JAX stack's weights, against the JAX stack's
Pallas routes in interpret mode."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.ops.pallas_ffn import _backward as jax_ffn_bwd
from geomae_tpu.ops.pallas_ffn import post_attention_block as jax_block
from geomae_tpu_torch.ops import ffn
from test_pallas_ffn import ORDER, make_case as ffn_case
from test_torch_port_band_ops import (DTYPES, assert_rows_close,
                                      check_route_against_pallas, stack_case,
                                      to_torch)

RATIO_WIDTHS = [(128, 128), (128, 384), (256, 256), (256, 768)]
TILE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def k5_case(C, F, dtype):
    """K5's inputs at (C, F) (``test_pallas_ffn.make_case``, V = 128, nv
    short of V in the first sample) for the port, a cotangent zero past
    nv, and the interpret-mode kernel's forward and ``_backward`` on them,
    in one compiled call: (port inputs, nv, keep, dy, JAX forward, JAX
    backward); each width's JAX results once for the file."""
    jdt, tdt = DTYPES[dtype]
    x, attn, ws = ffn_case(np.random.default_rng(40 + C + F), B=2, V=128,
                           C=C, F=F, dtype=jdt)
    nv = np.array([70, 128], np.int32)
    keep = np.arange(128)[None, :] < nv[:, None]
    dy = jnp.asarray(np.random.default_rng(7).normal(size=(2, 128, C))
                     * keep[..., None], jdt)

    def forward_backward(*a):
        return (jax_block(*a[:13], 1e-5, TILE, True),
                jax_ffn_bwd(*a, 1e-5, TILE, True))

    y, grads = jax.jit(forward_backward)(x, attn, *[ws[k] for k in ORDER],
                                         jnp.asarray(nv), dy)
    targs = (to_torch(x, tdt), to_torch(attn, tdt),
             *[to_torch(ws[k][0]) for k in ORDER])
    return targs, nv, keep, to_torch(dy, tdt), y, grads


def check_k5_forward(C, F, dtype):
    """The plain forward against the interpret-mode kernel on the rows
    before ``nv`` (the kernel computes the rest of ``nv``'s tile), f32 at
    1e-5; rows past ``nv`` 0."""
    targs, nv, keep, _, y, _ = k5_case(C, F, dtype)
    want = np.asarray(y.astype(jnp.float32))
    got = ffn.post_attention_block_plain(*targs, torch.from_numpy(nv))
    assert got.dtype == DTYPES[dtype][1]
    got = got.float().numpy()
    assert_rows_close(got[keep], want[keep], dtype, atol=1e-5, rtol=1e-5)
    assert (got[~keep] == 0).all()


def check_k5_backward(C, F, dtype):
    """The plain backward against the interpret-mode kernel's ``_backward``
    for a cotangent zero past ``nv``: dx and dattn per row, each parameter
    gradient, f32 at 1e-5 of its largest value; bf16 dx and dattn per row
    at 2e-2 + 2e-2 relative, its f32 parameter gradients at 2e-2 of their
    largest value (sums of bf16-rounded terms over 198 tokens)."""
    targs, nv, keep, dy, _, want = k5_case(C, F, dtype)
    got = ffn.post_attention_block_backward_plain(
        *targs, torch.from_numpy(nv), dy)
    for i, (a, w) in enumerate(zip(got, want)):
        w = np.asarray(w.astype(jnp.float32)).reshape(a.shape)
        a = a.float().numpy()
        if i < 2:                      # dx, dattn: per row, 0 past nv
            assert_rows_close(a[keep], w[keep], dtype, atol=1e-5, rtol=1e-5)
            assert (a[~keep] == 0).all()
            continue
        tol = 1e-5 if dtype == "f32" else 2e-2
        np.testing.assert_allclose(a, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=ORDER[i - 2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", RATIO_WIDTHS)
def test_k5_forward_at_ffn_ratio(C, F, dtype):
    """``check_k5_forward`` at F of C and 3 C."""
    check_k5_forward(C, F, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", RATIO_WIDTHS)
def test_k5_backward_at_ffn_ratio(C, F, dtype):
    """``check_k5_backward`` at F of C and 3 C."""
    check_k5_backward(C, F, dtype)


def test_sst_block_at_ffn_384_matches_the_jax_pallas_routes():
    """One block at C = 128 in 8 heads of 16, FFN 384, V = 128: the
    port's band / fused route (which ``check_route_against_pallas``
    asserts it resolves to) against the JAX stack's band / fused route in
    interpret mode, 1e-4 on the valid rows."""
    check_route_against_pallas(stack_case((128, 8, 384), V=128,
                                          grads=False))
