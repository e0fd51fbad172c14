"""The gradients of the port's kernels (their plain versions, on the CPU)
and the train step's other parts against the JAX package, f32, tiny
widths, inputs from numpy seeds.

* K1 / K2 gradients in every op, ties included, against ``jax.grad`` of
  the Pallas wrappers in interpret mode; the bf16 cotangent roundings
  against the JAX VJP functions themselves;
* segment_gather and its backward against ``segment_gather_pallas``;
* K5's twelve gradients and K7's seven against ``jax.grad`` of the Pallas
  kernels in interpret mode, and K7 over a window wider than the TPU's
  band against the XLA einsum path; the bf16 kernels' decomposition of
  K7 (the projections, K8's plain backward, the projections' plain
  backward) against the plain K7 and ``jax.grad``, and the projections'
  plain backward against autograd of their plain forward;
* masked BatchNorm in training (statistics, running update, gradients);
* anchor targets and the head loss, padded GT and the min_pos_iou
  branch included;
* the schedules, and AdamW with clipping and its decay mask against
  optax.

Each tolerance is stated in its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
from jax.experimental.pallas import tpu as pltpu

from geomae_tpu.config import OptimConfig, tiny_finetune_config
from geomae_tpu.models import anchor_head as jhead
from geomae_tpu.models.anchors import grid_anchors
from geomae_tpu.models.norm import MaskedBatchNorm as JaxBN
from geomae_tpu.models.norm import MaskedBatchNorm2d as JaxBN2d
from geomae_tpu.ops import pallas_segreduce as jseg
from geomae_tpu.ops.attention import band_attention as jax_band_attention
from geomae_tpu.ops.pallas_attention_qkv import _pallas_forward as jax_qkv_fwd
from geomae_tpu.ops.pallas_attention_qkv import band_attention_qkv as jax_qkv
from geomae_tpu.ops.pallas_ffn import post_attention_block as jax_ffn
from geomae_tpu.train import schedules as jsched
from geomae_tpu.train.optim import make_optimizer
from geomae_tpu_torch.models import anchor_head
from geomae_tpu_torch.models.anchor_head import HeadOutputs
from geomae_tpu_torch.models.norm import MaskedBatchNorm, MaskedBatchNorm2d
from geomae_tpu_torch.ops import attention, attention_qkv, ffn, segment
from geomae_tpu_torch.train import schedules
from geomae_tpu_torch.train.optim import AdamW

INT_MAX = np.iinfo(np.int32).max
t = torch.from_numpy


def grad_of(fn, *xs):
    """Gradients of fn(*leaves).sum() with respect to each torch leaf."""
    xs = [torch.from_numpy(np.array(a)).requires_grad_() for a in xs]
    fn(*xs).sum().backward()
    return [a.grad.numpy() for a in xs]


# ---------------------------------------------------------------------------
# K1, K2 and the gather
# ---------------------------------------------------------------------------

B, P, V, CHUNK = 2, 512, 96, 128


def segment_case(seed, C):
    """Ascending ids with gaps, empty trailing rows and a sentinel suffix;
    small-integer payloads, so maxima tie."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, V - 8, (B, P)), axis=1).astype(np.int32)
    for b in range(B):
        seg[b, int(rng.integers(P // 2, P - 16)):] = V
    x = rng.integers(-3, 4, (B, P, C)).astype(np.float32)
    occ = np.stack([np.isin(np.arange(V), s) for s in seg])
    return x, seg, occ, rng


@pytest.mark.parametrize("which,op", [
    ("reduce", "sum"), ("reduce", "max"), ("broadcast", "sum"),
    ("broadcast", "mean"), ("broadcast", "max")])
def test_segment_gradients_match_pallas(which, op):
    """dx of sum(op(x) * w).  Tolerance 1e-6 relative plus 1e-5
    absolute: f32 sums of a few dozen cotangents in another order, and
    the JAX backward of K2 sum / mean on the CPU differences a running
    cumsum over the row, whose f32 error grows with the prefix (3e-6
    here).  Every tied maximum gets the whole cotangent on both sides
    (PyTorch's own ``amax`` backward would split it, off by whole
    fractions)."""
    C = 6
    x, seg, occ, rng = segment_case(7, C)
    if which == "reduce":
        # rows no point maps to are garbage in the Pallas kernel
        w = rng.normal(size=(B, V, C)).astype(np.float32) * occ[..., None]
        jfn = lambda a: jseg.segment_reduce_pallas(a, jnp.asarray(seg), V,
                                                   op == "max", CHUNK)
        tfn = lambda a: segment.segment_reduce(a, t(seg), V, op)
    else:
        w = rng.normal(size=(B, P, C)).astype(np.float32)
        jfn = lambda a: jseg.segment_broadcast_pallas(a, jnp.asarray(seg), V,
                                                      op, CHUNK)
        tfn = lambda a: segment.segment_broadcast(a, t(seg), V, op)

    def loss(a):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jfn(a) * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    (got,) = grad_of(lambda a: tfn(a) * t(w), x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    if op == "max":      # more receivers than (segment, channel) maxima
        assert (got != 0).sum() > occ.sum() * C


def test_bf16_cotangent_roundings_match_the_jax_vjps():
    """bf16 payloads: K1 max rounds its cotangent to bf16 before the
    gather, K2 max sums it in f32 (``_reduce_bwd``, ``_bcast_bwd`` on
    the same residuals).  Exact for K1; K2's f32 sum in another order may
    round to the other bf16 neighbour: one bf16 ulp, 2^-7 relative."""
    x, seg, occ, rng = segment_case(8, 5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    g_red = rng.normal(size=(B, V, 5)).astype(np.float32)
    out = segment.segment_reduce(xb, t(seg), V, "max")
    xr = xb.clone().requires_grad_()
    segment.segment_reduce(xr, t(seg), V, "max").backward(t(g_red))
    want, _ = jseg._reduce_bwd(V, True, CHUNK, True,
                               (jx, jnp.asarray(seg), jnp.asarray(out)),
                               jnp.asarray(g_red))
    np.testing.assert_array_equal(xr.grad.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))

    g_b = torch.from_numpy(rng.normal(size=(B, P, 5)).astype(np.float32)
                           ).to(torch.bfloat16)
    xr = xb.clone().requires_grad_()
    outb = segment.segment_broadcast(xr, t(seg), V, "max")
    outb.backward(g_b)
    want, _ = jseg._bcast_bwd(V, "max", CHUNK, True,
                              (jx, jnp.asarray(outb.detach().float().numpy()
                                               ).astype(jnp.bfloat16),
                               jnp.asarray(seg)),
                              jnp.asarray(g_b.float().numpy()
                                          ).astype(jnp.bfloat16))
    np.testing.assert_allclose(xr.grad.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_segment_gather_and_its_gradient_match_pallas():
    """Forward exact (the Pallas kernel's exact f32 path routes hi and lo
    halves); the backward is K1 sum of the cotangent, 1e-6 relative plus
    1e-5 absolute (the JAX backward on the CPU differences a running
    cumsum, as for K2 sum above)."""
    rng = np.random.default_rng(9)
    _, seg, occ, _ = segment_case(9, 1)
    table = rng.normal(size=(B, V, 7)).astype(np.float32)
    w = rng.normal(size=(B, P, 7)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jseg.segment_gather_pallas(
            jnp.asarray(table), jnp.asarray(seg), CHUNK))
    got = segment.segment_gather(t(table), t(seg)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[seg == V] == 0).all()

    def loss(a):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jseg.segment_gather_pallas(
                a, jnp.asarray(seg), CHUNK) * w)

    gwant = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    (ggot,) = grad_of(lambda a: segment.segment_gather(a, t(seg)) * t(w),
                      table)
    np.testing.assert_allclose(ggot, gwant, rtol=1e-6, atol=1e-5)
    assert (ggot[~occ] == 0).all()


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

FFN_ORDER = ["wo", "bo", "s1", "t1", "w1", "b1", "w2", "b2", "s2", "t2"]


@pytest.mark.parametrize("nv", [None, (100, 77)])
def test_post_attention_block_gradients_match_pallas(nv):
    """All twelve gradients of sum(y * w) against ``jax.grad`` of the
    interpret-mode kernel; with ``nv`` the rows at and past it carry no
    cotangent (the port returns 0 there; the TPU computes the rest of
    their tile).  Tolerance 1e-5 relative to each gradient's largest
    value: f32 sums over 32-64 channels and 256 tokens in another
    order."""
    rng = np.random.default_rng(10)
    Bz, Vz, C, F = 2, 128, 32, 64
    arr = lambda *s, scale=0.3: (rng.normal(size=s) * scale).astype(
        np.float32)
    x, attn = arr(Bz, Vz, C, scale=1.0), arr(Bz, Vz, C, scale=1.0)
    ws = dict(wo=arr(C, C), bo=arr(C), s1=1 + arr(C, scale=0.1),
              t1=arr(C, scale=0.1), w1=arr(C, F), b1=arr(F), w2=arr(F, C),
              b2=arr(C), s2=1 + arr(C, scale=0.1), t2=arr(C, scale=0.1))
    w = arr(Bz, Vz, C, scale=1.0)
    if nv is not None:
        w = w * (np.arange(Vz)[None, :] < np.asarray(nv)[:, None])[..., None]
    nv_j = None if nv is None else jnp.asarray(nv, jnp.int32)
    nv_t = None if nv is None else torch.tensor(nv, dtype=torch.int32)

    def loss(*a):
        y = jax_ffn(a[0], a[1], *[p[None] for p in a[2:]], nv_j, 1e-5, 64,
                    True)
        return jnp.sum(y * w)

    args = [x, attn] + [ws[k] for k in FFN_ORDER]
    want = jax.grad(loss, argnums=tuple(range(12)))(
        *map(jnp.asarray, args))
    got = grad_of(lambda *a: ffn.post_attention_block(*a, nv_t) * t(w),
                  *args)
    for name, a, b in zip(["x", "attn"] + FFN_ORDER, got, want):
        b = np.asarray(b).reshape(a.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    if nv is not None:
        for b_, n in enumerate(nv):
            assert (got[0][b_, n:] == 0).all() and (got[1][b_, n:] == 0).all()


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def window_case(rng, Bz, Vz, C, max_win, gap=1):
    x = rng.normal(size=(Bz, Vz, C)).astype(np.float32)
    pos = rng.normal(size=(Bz, Vz, C)).astype(np.float32)
    win = np.full((Bz, Vz), INT_MAX, np.int32)
    for b in range(Bz):
        n, ids, wi = int(rng.integers(Vz // 2, Vz - 16)), [], 0
        while len(ids) < n:
            ids.extend([wi] * int(rng.integers(1, max_win + 1)))
            wi += gap
        win[b, :n] = ids[:n]
    kv = (rng.random((Bz, Vz)) > 0.25) & (win != INT_MAX)
    ws = []
    for _ in range(3):
        ws.append((rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32))
        ws.append((rng.normal(size=(C,)) * 0.1).astype(np.float32))
    w = rng.normal(size=(Bz, Vz, C)).astype(np.float32) * \
        (win != INT_MAX)[..., None]
    return x, pos, win, kv, ws, w


def check_attention_grads(got, want):
    """x's gradient at 2e-5 of its largest value, each weight's at 2e-5 of
    its own largest value or of 1e-2 of the largest weight gradient, where
    its own is below that (the key bias's gradient is analytically zero:
    softmax ignores a shift shared by all keys)."""
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=2e-5 * np.abs(want[0]).max())
    top = max(np.abs(b).max() for b in want[1:])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(
            a, b.reshape(a.shape), rtol=0,
            atol=2e-5 * max(np.abs(b).max(), 1e-2 * top))


def test_band_attention_qkv_gradients_match_pallas():
    """dx and dWq, dbq, dWk, dbk, dWv, dbv of sum(out * w) against
    ``jax.grad`` of the interpret-mode kernel (tile 64, band 128): C 32 in
    2 heads of 16, windows of up to 40 tokens.  Tolerance 2e-5 of the
    largest gradient: f32 softmax sums and projections in another order.
    ``pos`` gets no gradient."""
    rng = np.random.default_rng(11)
    H = 2
    x, pos, win, kv, ws, w = window_case(rng, 2, 256, 32, 40)

    def loss(x_, *ws_):
        out = jax_qkv(x_, jnp.asarray(pos), *[p[None] for p in ws_],
                      jnp.asarray(win), jnp.asarray(kv), H, 64, 128, True)
        return jnp.sum(out * w)

    want = [np.asarray(a) for a in jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, ws))]
    tpos = t(pos).requires_grad_()
    leaves = [t(a.copy()).requires_grad_() for a in [x] + ws]
    out = attention_qkv.band_attention_qkv(leaves[0], tpos, *leaves[1:],
                                           t(win), t(kv), H)
    (out * t(w)).sum().backward()
    check_attention_grads([a.grad.numpy() for a in leaves], want)
    assert tpos.grad is None


def test_band_attention_qkv_statistics_match_pallas():
    """The plain version of the forward kernel's statistics, the
    log-sum-exp per row and head, against the interpret-mode kernel's
    max m and sum l (m + log l) on rows with a valid key, and 0 on the
    others (a window whose keys are all invalid, and padding).  Tolerance 1e-5: f32 exponentials summed in another order."""
    rng = np.random.default_rng(13)
    H = 2
    x, pos, win, kv, ws, _ = window_case(rng, 2, 256, 32, 40)
    kv[0, win[0] == win[0, 0]] = False        # a window without a key
    _, stats = jax_qkv_fwd(jnp.asarray(x), jnp.asarray(pos),
                           *[jnp.asarray(p)[None] for p in ws],
                           jnp.asarray(win), jnp.asarray(kv), H, 64, 128,
                           True)
    stats = np.asarray(stats)
    m, l = stats[..., :H], stats[..., H:]
    got = attention_qkv.band_attention_qkv_lse_plain(
        t(x), t(pos), *map(t, ws), t(win), t(kv), H).numpy()
    seen = l > 0
    assert seen.any() and (~seen & (win != INT_MAX)[..., None]).any()
    np.testing.assert_allclose(got[seen], (m + np.log(np.where(seen, l, 1)))
                               [seen], rtol=0, atol=1e-5)
    assert (got[~seen] == 0).all()


def test_band_attention_qkv_gradients_over_a_wide_window():
    """Windows of up to 300 tokens, wider than the TPU kernel's +-192
    band, against projections + the XLA einsum ``band_attention`` with a
    band wide enough to be exact (tile 128, 3 bands).  Tolerance as
    above."""
    rng = np.random.default_rng(12)
    H, C = 2, 32
    x, pos, win, kv, ws, w = window_case(rng, 2, 1024, C, 300, gap=2)
    wq, bq, wk, bk, wv, bv = range(6)

    def loss(x_, *p):
        qk = x_ + pos
        proj = lambda a, i: a @ p[i] + p[i + 1]
        shape = (2, 1024, H, C // H)
        out = jax_band_attention(proj(qk, wq).reshape(shape),
                                 proj(qk, wk).reshape(shape),
                                 proj(x_, wv).reshape(shape),
                                 jnp.asarray(win), jnp.asarray(kv), 128, 3)
        return jnp.sum(out.reshape(x_.shape) * w)

    want = [np.asarray(a) for a in jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, ws))]
    got = grad_of(lambda x_, *p: attention_qkv.band_attention_qkv(
        x_, t(pos), *p, t(win), t(kv), H) * t(w), x, *ws)
    check_attention_grads(got, want)


def composed_backward(x, pos, ws, win, kv, H, g):
    """K7 as the bf16 kernels decompose it, in plain PyTorch: the
    projections, K8's forward and plain backward (dq, dk, dv for the
    cotangent g of the output), then the projections' backward."""
    B_, V_, C = x.shape
    heads = (B_, V_, H, C // H)
    q, k, v = (a.reshape(heads) for a in attention_qkv.qkv_project_plain(
        x, pos, *ws, win))
    out = attention.band_attention(q, k, v, win, kv)
    ds = attention.band_attention_backward_plain(q, k, v, win, kv, out,
                                                 g.reshape(heads))
    return attention_qkv.qkv_project_backward_plain(
        x, pos, *ws[0::2], *[d.reshape(x.shape) for d in ds])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_decomposition_is_the_plain_k7(dtype):
    """Projections -> K8's plain backward -> the projections' plain
    backward equals ``band_attention_qkv_backward_plain`` bitwise (the
    scale 0.25 is a power of two: on q before the scores or on the f32
    score, on dk after its sum or folded into q, the same numbers), C 32
    in 2 heads of 16, windows of up to 40 tokens, bf16 and f32."""
    rng = np.random.default_rng(14)
    H = 2
    x, pos, win, kv, ws, w = window_case(rng, 2, 256, 32, 40)
    args = (t(x).to(dtype), t(pos), *map(t, ws), t(win), t(kv))
    g = t(w).to(dtype)
    out = attention_qkv.band_attention_qkv_plain(*args, H)
    want = attention_qkv.band_attention_qkv_backward_plain(*args, H, out, g)
    got = composed_backward(args[0], args[1], list(args[2:8]), *args[8:],
                            H, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_k7_decomposition_matches_pallas():
    """The decomposition's gradients of sum(out * w) in f32 against
    ``jax.grad`` of the interpret-mode kernel, at
    ``check_attention_grads``'s 2e-5 of the largest gradient."""
    rng = np.random.default_rng(15)
    H = 2
    x, pos, win, kv, ws, w = window_case(rng, 2, 256, 32, 40)

    def loss(x_, *ws_):
        out = jax_qkv(x_, jnp.asarray(pos), *[p[None] for p in ws_],
                      jnp.asarray(win), jnp.asarray(kv), H, 64, 128, True)
        return jnp.sum(out * w)

    want = [np.asarray(a) for a in jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, ws))]
    got = composed_backward(t(x), t(pos), list(map(t, ws)), t(win), t(kv),
                            H, t(w))
    check_attention_grads([a.numpy() for a in got], want)


def test_projection_backward_is_the_projections_vjp():
    """``qkv_project_backward_plain`` against autograd of
    ``qkv_project_plain`` in f32, cotangents 0 on padding rows (as K8's
    backward gives them): 1e-5 of each gradient's largest value (the same
    products in another order)."""
    rng = np.random.default_rng(16)
    x, pos, win, _, ws, _ = window_case(rng, 2, 256, 32, 40)
    real = (win != INT_MAX)[..., None]
    ds = [t(rng.normal(size=x.shape).astype(np.float32) * real)
          for _ in range(3)]
    leaves = [t(a.copy()).requires_grad_() for a in [x] + ws]
    outs = attention_qkv.qkv_project_plain(leaves[0], t(pos), *leaves[1:],
                                           t(win))
    sum((o * d).sum() for o, d in zip(outs, ds)).backward()
    got = attention_qkv.qkv_project_backward_plain(t(x), t(pos), *map(
        t, ws[0::2]), *ds)
    for a, leaf in zip(got, leaves):
        b = leaf.grad
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# BatchNorm in training
# ---------------------------------------------------------------------------


def test_masked_batch_norm_training_matches_flax():
    """Masked one-pass moments, the running update (momentum 0.01,
    unbiased var) and the gradients through the statistics.  Tolerance
    1e-5 relative to each quantity's largest value (f32 sums over 600
    elements in another order)."""
    rng = np.random.default_rng(13)
    x = (rng.normal(size=(2, 300, 8)) * 3 + 1).astype(np.float32)
    mask = rng.random((2, 300)) > 0.3
    scale = (1 + rng.normal(size=8) * 0.1).astype(np.float32)
    bias = (rng.normal(size=8) * 0.1).astype(np.float32)
    mean0 = rng.normal(size=8).astype(np.float32)
    var0 = (1 + rng.random(8)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    bn = JaxBN(8)
    state = {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean0, "var": var0}}

    def loss(x_, s_, b_):
        v = {"params": {"scale": s_, "bias": b_},
             "batch_stats": state["batch_stats"]}
        y, mut = bn.apply(v, x_, jnp.asarray(mask), True,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y_j, st_j)), g_j = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(x, scale, bias)
    tbn = MaskedBatchNorm(8)
    with torch.no_grad():
        tbn.weight.copy_(t(scale))
        tbn.bias.copy_(t(bias))
        tbn.running_mean.copy_(t(mean0))
        tbn.running_var.copy_(t(var0))
    tbn.train()
    xt = t(x).requires_grad_()
    y = tbn(xt, t(mask))
    (y * t(w)).sum().backward()
    close = lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-5 * np.abs(np.asarray(b)).max())
    close(y.detach().numpy(), y_j)
    close(tbn.running_mean.numpy(), st_j["mean"])
    close(tbn.running_var.numpy(), st_j["var"])
    assert int(tbn.num_batches_tracked) == 1
    for a, b in zip((xt.grad, tbn.weight.grad, tbn.bias.grad), g_j):
        close(a.numpy(), b)
    assert (np.asarray(g_j[0])[~mask] != 0).any()    # the affine still
    tbn.eval()                                       # reaches them
    with torch.no_grad():
        inv = 1 / torch.sqrt(tbn.running_var + tbn.eps)
        want = t(x) * (tbn.weight * inv) + tbn.bias - \
            tbn.running_mean * tbn.weight * inv
        np.testing.assert_allclose(tbn(t(x)).numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_masked_batch_norm_2d_training_matches_flax():
    """NCHW here, NHWC there, every element in the statistics; tolerance
    as above."""
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(2, 6, 5, 4)) * 2 - 1).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    bn = JaxBN2d(4)
    v = bn.init(jax.random.PRNGKey(0), x, False)

    def loss(x_):
        y, mut = bn.apply(v, x_, True, mutable=["batch_stats"])
        return jnp.sum(y * w), mut["batch_stats"]

    (_, st), g = jax.value_and_grad(loss, has_aux=True)(x)
    tbn = MaskedBatchNorm2d(4).train()
    xt = t(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    (tbn(xt) * t(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    st = st["MaskedBatchNorm_0"]
    np.testing.assert_allclose(tbn.running_mean.numpy(), st["mean"],
                               atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), st["var"],
                               atol=1e-6)
    gw = np.asarray(g).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(xt.grad.numpy(), gw, rtol=0,
                               atol=1e-5 * np.abs(gw).max())


# ---------------------------------------------------------------------------
# anchor targets and the head loss
# ---------------------------------------------------------------------------


def head_case():
    """The tiny config's anchors (20 x 20 cells, 7 types x 2 rotations)
    and two samples of GT: boxes on anchor centres with anchor sizes
    (positive at 0.6), a 1 m square on a pedestrian anchor (best IoU
    below 0.6: positive only through min_pos_iou), and padding."""
    cfg = tiny_finetune_config()
    head = cfg.head
    anchors = grid_anchors(head, (20, 20))
    rng = np.random.default_rng(15)
    G = 8
    boxes = np.zeros((2, G, 9), np.float32)
    labels = np.full((2, G), -1, np.int32)
    mask = np.zeros((2, G), bool)
    for b in range(2):
        for g in range(5):
            a = anchors[rng.integers(len(anchors))].copy()
            a[:2] += rng.uniform(-0.1, 0.1, 2)
            a[6] += rng.uniform(-0.2, 0.2)
            a[7:] = rng.normal(size=2)
            boxes[b, g], labels[b, g], mask[b, g] = a, g, True
        ped = anchors[4 * 2 + 100 * 14].copy()       # type 4, a cell centre
        ped[3:5] = 1.0
        boxes[b, 5], labels[b, 5], mask[b, 5] = ped, 7, True
        boxes[b, 6:, :3] = 1.0                       # padding: not in mask
    return head, anchors, boxes, labels, mask


def test_assign_targets_match_jax():
    """Labels, weights, direction bins and counts exact; box targets at
    1e-6 (f32 logs and divisions)."""
    head, anchors, boxes, labels, mask = head_case()
    for b in range(2):
        want = jhead.assign_targets(jnp.asarray(anchors), jnp.asarray(
            boxes[b]), jnp.asarray(labels[b]), jnp.asarray(mask[b]), head)
        got = anchor_head.assign_targets(t(anchors), t(boxes[b]),
                                         t(labels[b]), t(mask[b]), head)
        for name in ("labels", "label_weights", "bbox_weights",
                     "dir_targets", "num_pos"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        np.testing.assert_allclose(got.bbox_targets.numpy(),
                                   np.asarray(want.bbox_targets), atol=1e-6)
        # the 1 m square's anchors are positive through min_pos_iou alone
        from geomae_tpu_torch.core import boxes as TB
        iou = TB.aligned_iou_2d(TB.nearest_bev(t(anchors)),
                                TB.nearest_bev(t(boxes[b, 5:6])))[:, 0]
        assert 0.3 <= float(iou.max()) < 0.6
        assert int(got.labels[int(iou.argmax())]) == 7


def test_head_loss_and_its_gradient_match_jax():
    """Focal, smooth-L1 (sin-difference) and direction losses, and their
    gradients with respect to the head maps (NCHW here, NHWC there).
    Tolerance 1e-5 relative: f32 sums over 22,400 anchors x 10 classes in
    another order."""
    head, anchors, boxes, labels, mask = head_case()
    rng = np.random.default_rng(16)
    A = len(head.anchor_sizes) * len(head.rotations)
    maps = [rng.normal(size=(2, 20, 20, A * n)).astype(np.float32)
            for n in (head.num_classes, head.code_size, 2)]

    def loss(*m):
        d = jhead.head_loss(jhead.HeadOutputs(*m), jnp.asarray(anchors),
                            jnp.asarray(boxes), jnp.asarray(labels),
                            jnp.asarray(mask), head)
        return sum(d.values()), d

    (_, want), gwant = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(*maps)
    leaves = [t(m.transpose(0, 3, 1, 2).copy()).requires_grad_()
              for m in maps]
    got = anchor_head.head_loss(HeadOutputs(*leaves), t(anchors), t(boxes),
                                t(labels), t(mask), head)
    for k, v in got.items():
        np.testing.assert_allclose(float(v.detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    for a, b in zip(leaves, gwant):
        b = np.asarray(b).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------


def test_schedules_match_jax():
    """lr and beta1 of the fine-tune config's one cycle at its edges and
    between; 1e-6 relative, plus 1e-6 of the cycle's peak lr absolute
    (JAX evaluates in f32, the port in f64: near the end of the cycle
    ``cos(pi * pct) + 1`` cancels in f32)."""
    o = tiny_finetune_config().optim
    total = 1000
    lr_j = jsched.cyclic_schedule(o.lr, o.target_ratio, o.step_ratio_up,
                                  total)
    b1_j = jsched.cyclic_momentum_schedule(o.betas[0], o.momentum_ratio,
                                           o.step_ratio_up, total)
    lr_t = schedules.cyclic_schedule(o.lr, o.target_ratio, o.step_ratio_up,
                                     total)
    b1_t = schedules.cyclic_momentum_schedule(
        o.betas[0], o.momentum_ratio, o.step_ratio_up, total)
    peak = o.lr * o.target_ratio[0]
    for step in (0, 1, 250, 399, 400, 401, 700, 999, 1500):
        np.testing.assert_allclose(lr_t(step), float(lr_j(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-6 * peak)
        np.testing.assert_allclose(b1_t(step), float(b1_j(jnp.asarray(step))),
                                   rtol=1e-6)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(4, 3)
        self.norm = nn.LayerNorm(3)
        self.bn = MaskedBatchNorm(3)


def test_adamw_with_clip_and_decay_mask_matches_optax():
    """Four updates of ``make_optimizer``'s chain (global-norm clip, AdamW
    with the cyclic lr and beta1 injected per step, no decay on norm
    parameters) against the port's AdamW, the second gradient above the
    clip norm.  Tolerance 1e-6 relative plus 1e-5 of the largest lr
    (0.1) absolute: an update is about lr in size, its hyperparameter
    arithmetic runs in f32 there and f64 here, and the first moment
    cancels where consecutive gradients oppose."""
    cfg = OptimConfig(lr=1e-2, weight_decay=0.05, grad_clip_norm=1.0,
                      target_ratio=(10.0, 1e-4), step_ratio_up=0.4,
                      momentum_ratio=(0.85 / 0.95, 1.0), total_steps=10)
    rng = np.random.default_rng(17)
    model = _Tiny()
    flat = {("dense", "kernel"): model.dense.weight.detach().numpy().T,
            ("dense", "bias"): model.dense.bias.detach().numpy(),
            ("norm", "scale"): model.norm.weight.detach().numpy() + 0.1,
            ("norm", "bias"): model.norm.bias.detach().numpy() + 0.2,
            ("bn", "MaskedBatchNorm_0", "scale"):
                model.bn.weight.detach().numpy() - 0.1,
            ("bn", "MaskedBatchNorm_0", "bias"):
                model.bn.bias.detach().numpy() + 0.3}
    with torch.no_grad():
        model.norm.weight += 0.1
        model.norm.bias += 0.2
        model.bn.weight -= 0.1
        model.bn.bias += 0.3
    from flax.traverse_util import unflatten_dict
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()})
    to_port = {("dense", "kernel"): model.dense.weight,
               ("dense", "bias"): model.dense.bias,
               ("norm", "scale"): model.norm.weight,
               ("norm", "bias"): model.norm.bias,
               ("bn", "MaskedBatchNorm_0", "scale"): model.bn.weight,
               ("bn", "MaskedBatchNorm_0", "bias"): model.bn.bias}
    tx = make_optimizer(cfg)
    opt = tx.init(params)
    adamw = AdamW(model, cfg)
    for step in range(4):
        g = {k: (rng.normal(size=v.shape) * (3.0 if step == 1 else 0.1))
             .astype(np.float32) for k, v in flat.items()}
        upd, opt = tx.update(unflatten_dict(
            {k: jnp.asarray(v) for k, v in g.items()}), opt, params)
        params = optax.apply_updates(params, upd)
        for k, p in to_port.items():
            gk = g[k].T if k == ("dense", "kernel") else g[k]
            p.grad = torch.from_numpy(gk.copy())
        norm = adamw.step()
        assert (float(norm) > 1.0) == (step == 1)
        from flax.traverse_util import flatten_dict
        for k, v in flatten_dict(params).items():
            want = np.asarray(v).T if k == ("dense", "kernel") \
                else np.asarray(v)
            np.testing.assert_allclose(to_port[k].detach().numpy(), want,
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} step {step}")
