"""K6 and K7 (``ops/attention_qkv.py``, the ``qkv`` route) at the widths
K8 takes, against the JAX package on the CPU.

The plain forward, its statistics and its backward (dx and the six
parameter gradients) against ``band_attention_qkv``'s ``_pallas_forward``
and ``_pallas_backward_merged`` in interpret mode, V = 256 (a multiple of
128, as the JAX kernel takes), one sample with a padding suffix and a
window whose keys are all invalid, at (C, H, D) = (256, 8, 32), where
the scale multiplies the f32 score, and (128, 2, 64) and (256, 4, 64),
where it folds into q (D a power of four).  f32 and bf16 at the rules
``test_torch_port_widths.py`` states for K8: f32 2e-5 + 2e-4 relative,
the statistics 1e-5; bf16 2e-2 + 2e-2 relative with atol times each row's
max(1, largest |ref|) (both round at the same points; f32 sums in another
order may move a rounding to the other side).  The parameter gradients,
sums over the tokens, at 2e-5 (f32) or 2e-2 (bf16) of max(their own
largest value, 1e-2 of the largest of the six): the key bias's gradient
is analytically 0, its own value rounding noise, so each package's is
held to 0 instead, by F3's rule at the dtype's unit roundoff u
(``probe_qkv.dbk_bound``: (u + n 2^-24) sum |dk| per channel, from the
port's f32 dk; u = 2^-8 in bf16, 2^-24 in f32), which the query bias's
gradient and the key bias's with one row's dk left out break.  Each
width's JAX results are computed once for the file (``jax_case``) and
shared by the forward and backward tests, and ``check_k6_forward`` /
``check_k7_backward`` by ``test_torch_port_qkv_channel_widths.py``.
Then one SST block at 256 in 8 heads of 32 on the port's ``qkv`` /
``fused`` route (K6 and K5: their plain versions here) against the JAX
stack on its ``qkv`` / ``fused`` route in interpret mode, from
``from_flax`` of its weights."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.ops.pallas_attention_qkv import (
    _pallas_backward_merged as jax_qkv_bwd)
from geomae_tpu.ops.pallas_attention_qkv import _pallas_forward as jax_qkv_fwd
from geomae_tpu_torch import probe_qkv
from geomae_tpu_torch.ops import attention_qkv
from test_torch_port_band_ops import (DTYPES, assert_rows_close,
                                      check_route_against_pallas, stack_case,
                                      to_torch)

INT_MAX = np.iinfo(np.int32).max
WIDTHS = [(256, 8), (128, 2), (256, 4)]     # (C, heads): D 32, 64, 64
V, TILE, PAD = 256, 64, 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv_inputs(rng, C):
    """One sample of V window-sorted tokens: windows of 1 to 40 tokens,
    a padding suffix, a fifth of the keys invalid and the first window's
    keys all invalid; x, pos, the six weights and a cotangent zero on the
    padding rows, f32."""
    win = np.full((1, V), INT_MAX, np.int32)
    n, ids, w = int(rng.integers(V // 2, V - 30)), [], 0
    while len(ids) < n:
        ids.extend([w] * int(rng.integers(1, 41)))
        w += 2
    win[0, :n] = ids[:n]
    kv = (rng.random((1, V)) > 0.2) & (win != INT_MAX)
    kv[0, win[0] == win[0, 0]] = False          # a window without a key
    x, pos = (rng.normal(size=(1, V, C)).astype(np.float32) for _ in "xp")
    ws = []
    for _ in range(3):
        ws.append((rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32))
        ws.append((rng.normal(size=(C,)) * 0.1).astype(np.float32))
    g = (rng.normal(size=(1, V, C)) * (win != INT_MAX)[..., None]).astype(
        np.float32)
    return x, pos, ws, win, kv, g


@functools.lru_cache(maxsize=None)
def jax_case(C, H, dtype):
    """(the port's inputs, the interpret-mode kernel's (out, statistics)
    and merged backward (dx, dWq, dbq, dWk, dbk, dWv, dbv)) at C in H
    heads; the backward from the kernel's own forward, both in one
    compiled call."""
    jdt, tdt = DTYPES[dtype]
    x, pos, ws, win, kv, g = qkv_inputs(np.random.default_rng(C + H), C)
    jx, jpos, jg = (jnp.asarray(a, jdt) for a in (x, pos, g))
    jws = [jnp.asarray(w)[None] for w in ws]
    jw, jkv = jnp.asarray(win), jnp.asarray(kv)
    def forward_backward(*a):
        out, stats = jax_qkv_fwd(*a[:10], H, TILE, PAD, True)
        return out, stats, jax_qkv_bwd(*a[:10], out, stats, a[10], H, TILE,
                                       PAD, True)

    out, stats, grads = jax.jit(forward_backward)(jx, jpos, *jws, jw, jkv,
                                                   jg)
    port = (to_torch(jx, tdt), to_torch(jpos, tdt),
            *(torch.from_numpy(w) for w in ws), torch.from_numpy(win),
            torch.from_numpy(kv))
    return port, to_torch(jg, tdt), (out, np.asarray(stats),
                                     [np.asarray(a.astype(jnp.float32))
                                      for a in grads])


def check_k6_forward(C, H, dtype):
    """The plain forward against ``_pallas_forward`` in interpret mode on
    the real rows, padding rows 0; f32 statistics (m + log l where a row
    sees a key) at 1e-5, 0 elsewhere."""
    args, _, (want, stats, _) = jax_case(C, H, dtype)
    got = attention_qkv.band_attention_qkv_plain(*args, H)
    assert got.dtype == DTYPES[dtype][1]
    real = (args[8] != INT_MAX).numpy()
    assert_rows_close(got.float().numpy()[real],
                      np.asarray(want.astype(jnp.float32))[real], dtype)
    assert (got.float().numpy()[~real] == 0).all()
    if dtype == "f32":
        m, l = stats[..., :H], stats[..., H:]
        lse = attention_qkv.band_attention_qkv_lse_plain(*args, H).numpy()
        seen = l > 0
        assert seen.any() and (~seen & real[..., None]).any()
        np.testing.assert_allclose(
            lse[seen], (m + np.log(np.where(seen, l, 1)))[seen], rtol=0,
            atol=1e-5)
        assert (lse[~seen] == 0).all()


def check_k7_backward(C, H, dtype):
    """The plain backward (from the plain forward's output) against the
    interpret-mode ``_pallas_backward_merged`` (from the kernel's): dx per
    row, 0 on padding rows; each parameter gradient at 2e-5 (f32) or 2e-2
    (bf16) of max(its own largest value, 1e-2 of the largest of the
    six), but the key bias's.  That one is analytically 0, and each
    package's is rounding noise, so both are held to 0 rather than to
    each other, by F3's forward-error bound of the sum each computes at
    the dtype's unit roundoff (``probe_qkv.dbk_bound``): in f32 (2^-24 +
    n 2^-24) sum_j |dk_jc|.  The f32 rule it replaces, 2e-5 of max(...),
    sat at the noise: JAX's dbk read 1.11 of it at (384, 4), 1.46-2.09
    at heads of 192 and 256.  Both packages' read 0.007-0.012 of the f32
    bound at (128, 2), (256, 4), (256, 8), (384, 4), (384, 8), (384, 12)
    and (512, 8), and 0.012-0.021 at (256, 1), (384, 2) and (512, 2).
    Two planted faults break it by 2e3 or more: a dbk taken from the
    query bias's gradient, and the port's dbk with the dk of one real row
    (the largest) left out."""
    args, g, (_, _, want) = jax_case(C, H, dtype)
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
    bound = probe_qkv.dbk_bound(dk, DTYPES[dtype][1]).numpy()
    for name, a, w in zip(probe_qkv.GRAD_NAMES, got[1:], want[1:]):
        assert a.dtype == torch.float32
        atol = tol * max(np.abs(w).max(), 1e-2 * top)
        if name == "bk":                  # 0 within F3's bound
            for dbk in (a.numpy(), w):
                assert (np.abs(dbk) <= bound).all(), np.abs(dbk / bound).max()
            dbq = got[1 + probe_qkv.GRAD_NAMES.index("bq")].numpy()
            row = int(dk[0].abs().sum(-1).argmax())
            assert real[0, row]
            for fault in (dbq, a.numpy() - dk[0, row].numpy()):
                assert not (np.abs(fault) <= bound).all()
            continue
        np.testing.assert_allclose(a.numpy(), w.reshape(a.shape), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=lambda w: str(w))
def test_k6_forward_and_statistics_at_width(C, H, dtype):
    """``check_k6_forward`` at (256, 8), (128, 2) and (256, 4)."""
    check_k6_forward(C, H, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", WIDTHS, ids=lambda w: str(w))
def test_k7_backward_at_width(C, H, dtype):
    """``check_k7_backward`` at (256, 8), (128, 2) and (256, 4)."""
    check_k7_backward(C, H, dtype)


def test_sst_block_at_256_matches_the_jax_qkv_route():
    """One block at C = 256 in 8 heads of 32, FFN 512, V = 128, on the
    port's qkv / fused route (K6, K5: their plain versions here) against
    the JAX stack's qkv / fused route in interpret mode, 1e-4 on the valid
    rows."""
    check_route_against_pallas(stack_case((256, 8, 512), V=128,
                                          grads=False), "qkv")
