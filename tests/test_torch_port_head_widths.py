"""K8's plain versions at the head widths 8 and 128, against the JAX
package on the CPU (K6 / K7 and the SST blocks at these widths:
``test_torch_port_head_widths_qkv_16.py`` and ``_qkv_1.py``, two widths
and one block each, so that each file stays under 40 s alone; this file
keeps ``k8_case``, which the other head-width files import, and
``check_k7_at_head_width``).

K8 (``ops/attention.py``) and K6 / K7 (``ops/attention_qkv.py``, the
``qkv`` route) at (C, H, D) = (128, 16, 8), (128, 1, 128), (256, 32, 8)
and (256, 2, 128): at D = 8 and 128 the scale 1/sqrt(D) is no power of
two, so it multiplies the f32 score in both packages.  K8's plain
forward and statistics against ``band_attention_pallas``'s
``_pallas_forward`` in interpret mode at V 128 and its plain backward
against ``_pallas_backward``; at 16 and 32 heads JAX's backward refuses
the width (it packs 3 H + 1 rows of statistics into 32 sublanes,
``geomae_tpu/ops/pallas_attention.py:493``), so there the backward is
held to the vjp of the JAX einsum route (``geomae_tpu/ops/attention.py:
band_attention``, the reference ``tests/test_pallas_attention.py`` holds
the Pallas gradients to) in f32 on the same values.  K6 / K7's plain
versions against ``band_attention_qkv``'s ``_pallas_forward`` /
``_pallas_backward_merged`` at V 256 (JAX's qkv route takes every head
count), the forward through ``test_torch_port_qkv_widths.py``'s check.
The rules are those of ``test_torch_port_widths.py``: f32 2e-5 + 2e-4
relative, the statistics 1e-5; bf16 2e-2 + 2e-2 relative with atol
times each row's max(1, largest |ref|); the qkv parameter gradients at
2e-5 (f32) or 2e-2 (bf16) of max(their own largest value, 1e-2 of the
largest of the six), the key bias's, analytically 0, by F3's bound in
both dtypes (``check_k7_at_head_width``).  Each width's JAX results
are computed once a file (``k8_case``, ``jax_case``).  Then one SST
block at C 128 in 16 heads of 8 and in one head of 128 on the port's
``band`` and ``qkv`` routes (with ``fused``) against the JAX stack's
Pallas routes in interpret mode, from ``from_flax`` of its weights."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_qkv_widths as qkv_widths
from geomae_tpu.ops.attention import band_attention as jax_einsum
from geomae_tpu.ops.pallas_attention import _pallas_backward as jax_band_bwd
from geomae_tpu.ops.pallas_attention import _pallas_forward as jax_band_fwd
from geomae_tpu_torch import probe_qkv
from geomae_tpu_torch.ops import attention, attention_qkv
from test_torch_port_band_ops import (DTYPES, assert_rows_close, make_case,
                                      to_torch)

INT_MAX = np.iinfo(np.int32).max
# (C, heads): D 8 and 128 at C 128 and 256
HEAD_WIDTHS = [(128, 16), (128, 1), (256, 32), (256, 2)]
WIDTH_IDS = [f"{c}in{h}" for c, h in HEAD_WIDTHS]
JAX_BWD_HEADS = 10        # the most heads JAX's K8 backward takes
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
def k8_case(H, D, dtype, forward=True):
    """One sample of 128 window-sorted tokens at (H, D) with a window
    whose keys are all invalid and a cotangent zero on the padding rows;
    the interpret-mode kernel's forward (out, statistics; None without
    ``forward``, where H is past JAX's backward and only the reference
    backward is asked for) and the reference backward (dq, dk, dv) on
    them, in one compiled call: JAX's ``_pallas_backward`` where it takes
    H, else the vjp of the einsum route in f32 on the same values.
    (torch inputs, JAX outputs), once a width for the file."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, win, kv = make_case(np.random.default_rng(20 + D + H), B=1,
                                 V=128, H=H, D=D)
    kv[0, win[0] == win[0, 0]] = False          # a window without a key
    real = (win != INT_MAX)[..., None, None]
    g = (np.random.default_rng(2).normal(size=q.shape) * real).astype(
        np.float32)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jw, jkv = jnp.asarray(win), jnp.asarray(kv)

    def forward_backward(*a):
        out, stats = jax_band_fwd(*a[:5], TILE, 128, True) if forward \
            else (None, None)
        if H <= JAX_BWD_HEADS:
            grads = jax_band_bwd(*a[:5], out, stats, a[5], TILE, 128, True)
        else:
            f32 = [t.astype(jnp.float32) for t in a[:3]]
            _, vjp = jax.vjp(lambda *x: jax_einsum(*x, a[3], a[4], TILE),
                             *f32)
            grads = vjp(a[5].astype(jnp.float32))
        return out, stats, grads

    out, stats, grads = jax.jit(forward_backward)(jq, jk, jv, jw, jkv, jg)
    torch_in = (*(to_torch(a, tdt) for a in (jq, jk, jv)),
                torch.from_numpy(win), torch.from_numpy(kv),
                to_torch(jg, tdt))
    return torch_in, (out, None if stats is None else np.asarray(stats),
                      grads)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", HEAD_WIDTHS, ids=WIDTH_IDS)
def test_k8_forward_and_statistics_at_head_width(C, H, dtype):
    """The plain forward against ``_pallas_forward`` in interpret mode on
    the real rows, padding rows 0; f32 statistics (m + log l where a row
    sees a key) at 1e-5, 0 elsewhere."""
    (tq, tk, tv, tw, tkv, _), (want, stats, _) = k8_case(H, C // H, dtype)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", HEAD_WIDTHS, ids=WIDTH_IDS)
def test_k8_backward_at_head_width(C, H, dtype):
    """The plain backward against ``k8_case``'s reference backward, with
    a window whose keys are all invalid, per row; padding rows 0."""
    (tq, tk, tv, tw, tkv, tg), (_, _, want) = k8_case(H, C // H, dtype)
    out = attention.band_attention(tq, tk, tv, tw, tkv)
    got = attention.band_attention_backward_plain(tq, tk, tv, tw, tkv, out,
                                                  tg)
    pad = (tw[0] == INT_MAX).numpy()
    for a, w in zip(got, want):
        assert a.dtype == DTYPES[dtype][1]
        a = a.float().numpy()
        assert_rows_close(a.reshape(*a.shape[:2], -1),
                          np.asarray(w.astype(jnp.float32)).reshape(
                              *a.shape[:2], -1), dtype)
        assert pad.any() and (a[0, pad] == 0).all()


def check_k7_at_head_width(C, H, dtype):
    """The plain K7 (from the plain forward's output) against the
    interpret-mode ``_pallas_backward_merged`` (from the kernel's): dx per
    row, 0 on padding rows; each parameter gradient at 2e-5 (f32) or 2e-2
    (bf16) of max(its own largest value, 1e-2 of the largest of the six).
    The key bias's gradient is analytically 0 (softmax ignores a shift
    shared by a row's keys), so both packages' are rounding noise and
    each is held to 0 by F3's bound: in bf16 ``probe_qkv.dbk_bound``, in
    f32 the same bound at f32's unit roundoff, (2^-24 + n 2^-24) sum_j
    |dk_jc| (each dk rounded once, then n rows summed).  In f32 the
    floor rule's atol does not hold the noise at D 128: JAX's own dbk
    reads 1.07 (256 in 2) and 1.22 (128 in 1) of it, both packages about
    0.014 of the f32 bound."""
    args, g, (_, _, want) = qkv_widths.jax_case(C, H, dtype)
    out = attention_qkv.band_attention_qkv_plain(*args, H)
    got = attention_qkv.band_attention_qkv_backward_plain(*args, H, out, g)
    dx = got[0]
    assert dx.dtype == DTYPES[dtype][1]
    real = (args[8] != INT_MAX).numpy()
    assert_rows_close(dx.float().numpy()[real], want[0][real], dtype)
    assert (dx.float().numpy()[~real] == 0).all()
    tol = 2e-5 if dtype == "f32" else 2e-2
    top = max(np.abs(w).max() for w in want[1:])
    dk = attention_qkv.attention_grads_plain(*args, H, out, g)[1]
    n = dk.shape[0] * dk.shape[1]
    bound = (probe_qkv.dbk_bound(dk) if dtype == "bf16" else
             (1 + n) * 2.0 ** -24 * dk.abs().sum((0, 1))).numpy()
    for name, a, w in zip(probe_qkv.GRAD_NAMES, got[1:], want[1:]):
        assert a.dtype == torch.float32
        if name == "bk":
            for dbk in (a.numpy(), w):        # 0 within F3's bound
                assert (np.abs(dbk) <= bound).all(), \
                    float(np.abs(dbk / bound).max())
            continue
        atol = tol * max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(a.numpy(), w.reshape(a.shape), rtol=0,
                                   atol=atol, err_msg=name)
