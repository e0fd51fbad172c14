"""The port's CUDA kernels against their plain versions, on a CUDA GPU.

Marked ``cuda``; each test skips when there is no card.  This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerances (atol, rtol): maxima are exact; f32 sums and projections in
another order, 1e-4; in bf16 the same order differences may move a
compute-dtype rounding to the other side, at the output or at an
intermediate point (bias adds, LayerNorm output, GELU; the attention
kernel's probabilities, rounded against a running max): one bf16 ulp is
at most 2^-7 relative and 2^-6 = 1.6e-2 absolute for outputs below 4.

Backward kernels: the gather is exact; per-token cotangents are held at
the forward's bound with atol scaled by each row's largest reference
value (at least 1), plus ``rtol`` relative; each parameter gradient by
its largest error against WGRAD_TOL of its own largest value, or of
WGRAD_FLOOR of the kernel's largest parameter gradient where its own is
below that (f32 1e-4: sums over thousands of tokens in another order;
bf16 1e-3: a flipped rounding of one token's intermediate moves one term
of the sum by an ulp, while a bf16 rounding of the f32 gradients
themselves would show at up to 2^-9).  The floor (1e-2 in f32, 1e-1 in
bf16) is for the key bias: its gradient is analytically zero (softmax
ignores a shift shared by all keys), so its own largest value is
rounding noise, larger in bf16, where each token's dk is rounded before
the sum.  K5's ten bf16 parameter gradients are held instead by F5's
rule (``check_k5_backward``): the kernel's and the plain version's each
against the plain backward computed with f64 values and sums at the same
bf16 rounding points, at (2^-8 + n 2^-24) sum |terms| per element
(``probe_k5_backward.grad_bounds``), which a dropped token's terms
break; and by their precision: at most a quarter of a gradient's
elements end in 16 zero bits, as all of a gradient rounded to bf16 do
(``probe_k5_backward.low_bits_shares``).  K6's statistics (the
log-sum-exp per row and head) are held at K6's bound.

The targets' kernels: K3's counts (0/1 payloads) and K4 (a copy) are
exact; K3's sums of the same terms in another order differ by at most
2 (n - 1) 2^-24 sum |terms| for a cell of n points, held at
count x 2^-23 x sum |terms|.  The SST kernels also run at the pretrain
encoder's shape: [B, 8192, 128] visible tokens, 30 % of the pillars.

K5's and K8's bf16 forwards (the tensor-core kernels) also against their
plain versions per row at extents of 0, a part of V and V, V not a
multiple of the 64-token tile, and (K8) against its tile twin
``band_attention_tiles_plain`` on windows of 1 to 300 tokens with one
launch a call and two launches bitwise equal.

K6's and K7's bf16 projections (``qkv_project``, ``qkv_project_backward``,
the tensor-core kernels that bf16 K6 and K7 run around K8's): q, k, v
at K6's bound per row, 0 on padding rows; dx per row and the parameter
gradients by the backward rule; one launch a call, two launches bitwise
equal, at one sample, a batch and the encoder's [4, 8192].  K6, K7 and
the projections also at every width they take (``QKV_HEADS``: C 128,
256, 384 and 512 in heads of 1, 2, 4 and 8 to 128, C 384 in heads of 3,
6, 12, 24, 48, 96 and 192, C 256 and 512 in heads of 256, C 384 and 512
in one head, C 640, 768 and 1024 in heads of 8 to 128; the projections
at every C, streaming their contraction above 512), f32 and bf16, with
K7's dbk under F3's rule in both dtypes and its bf16 parameter
gradients at ``probe_qkv.wgrad_tol`` of the width (6e-3 at C 128, 3e-3
at 256 to 512, 6e-3 / 7e-3 / 6e-3 at 640 / 768 / 1024, 1e-2 to 1.5e-2
below heads of 8), a dropped row failing it, and by their precision
(``probe_k5_backward.low_bits_shares``, as K5's: at most a quarter of a
gradient's elements ending in 16 zero bits), which the kernel's
gradients rounded to bf16 fail; a width outside the set (C 640 in heads
of 4 or one head, 768 and 1024 in heads of 256, 1024 in heads of 4, and
C 1152) raises.

K8 (window attention over projected q, k, v; ``ops/attention.py``): the
output and the statistics at K6's bound, the backward's dq, dk, dv at the
per-row rule of the other backward cotangents (it has no parameter
gradients), at four layouts: one sample, a batch, the encoder's, and
windows of 1 to 300 tokens with one that has no valid key.  Its
prologue (D = rowsum(dO * out)) sums D exact products in another order.
K8 and K5 run at every width of their kernels: K8 in ``HEADS`` (C of 128,
256, 384 or 512 in heads of 1, 2, 4, 8, 16, 32, 64 or 128, C 384 in
heads of 3, 6, 12, 24, 48, 96 or 192, C 256 and 512 in heads of 256, C
384 and 512 in one head, C 640, 768 and 1024 in heads of 8 to 128), K5
in ``ffn.KERNEL_WIDTHS`` (F of 1 to 4 times C at C 128, 256, 384, 512,
640, 768 and 1024), and refuse widths outside them (K5 at (512, 2560),
(640, 5120) and C 1152, K8 at C 32, at 640 in heads of 4 and 5, at 768
in one head and in heads of 6 and 256, at 1024 in heads of 4 and at C
1152).  At heads
of 2, 3, 6, 12, 24, 48, 96, 192, 384 and 512 K8's and K6's outputs fail
their rule against the plain versions with the scale a power of two (1,
1/2, 1/2, 1/4, 1/4, 1/8, 1/8, 1/16, 1/16 and 1/16; at D 12 the scale of
the 16-channel slots its bf16 kernels run over), a planted fault;
K8's bf16 backward also under F3's key-bias rule: the column sums of its
dk, an exact 0 (``probe_qkv.dbk_bound``).
K4 also on spans with no key, a full span and an all-sentinel sample.
"""
import numpy as np
import pytest
import torch

from geomae_tpu_torch import probe_k5_backward, probe_qkv
from geomae_tpu_torch.ops import (attention, attention_qkv, ffn, segment,
                                  targets)

INT_MAX = 2 ** 31 - 1
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
DTYPES = [torch.float32, torch.bfloat16]
# K8's widths, (heads, head width): C = 128, 256, 384 and 512 in heads of
# 1, 2, 4, 8, 16, 32, 64 and 128, C 384 in heads of 3, 6, 12, 24, 48, 96
# and 192, C 256 and 512 in heads of 256, C 384 and 512 in one head, C
# 640, 768 and 1024 in heads of 8 to 128 (``attention.kernel_widths``);
# K6's and K7's (QKV_HEADS) the same;
# SHIPPED is the shipped width, 128 in 8 heads of 16
HEADS = [(C // D, D) for C, D in attention.kernel_widths()]
QKV_HEADS = [(C // D, D) for C, D in attention.kernel_widths()
             if attention_qkv.kernel_takes(C, C // D)]
# the widths whose 1/sqrt(D) is no power of two: C 384 in 32 heads of
# 12, 16 of 24, 8 of 48, 4 of 96, 2 of 192 and one of 384, C 512 in one
# of 512, C 128 in 64 heads of 2, C 384 in 128 of 3 and 64 of 6
ODD_HEADS = [(32, 12), (16, 24), (8, 48), (4, 96), (2, 192), (1, 384),
             (1, 512), (64, 2), (128, 3), (64, 6)]
SHIPPED = (8, 16)
HEAD_IDS = [f"{h}x{d}" for h, d in HEADS]
QKV_HEAD_IDS = [f"{h}x{d}" for h, d in QKV_HEADS]
FFN_IDS = [f"{c}-{f}" for c, f in ffn.KERNEL_WIDTHS]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def segments(rng, B=2, P=4096, V=700):
    """Ascending ids with gaps, empty trailing rows, a sentinel suffix."""
    seg = np.sort(rng.integers(0, V - 20, (B, P)), axis=1).astype(np.int32)
    for b in range(B):
        seg[b, int(rng.integers(P // 2, P - 100)):] = V
    return torch.from_numpy(seg), V


def windows(rng, B=2, V=1024, win_size=150):
    win = np.full((B, V), INT_MAX, np.int32)
    for b in range(B):
        n, ids, w = int(rng.integers(V // 2, V - 100)), [], 0
        while len(ids) < n:
            ids.extend([w] * int(rng.integers(1, win_size + 1)))
            w += 3
        win[b, :n] = ids[:n]
    kv = (rng.random((B, V)) > 0.2) & (win != INT_MAX)
    return torch.from_numpy(win), torch.from_numpy(kv)


def check(got, want, atol, rtol):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,C", [("sum", 3), ("max", 128), ("max", 5)])
def test_segment_reduce(dev, dtype, op, C):
    rng = np.random.default_rng(0)
    seg, V = segments(rng)
    x = torch.randn(seg.shape + (C,), dtype=dtype)
    x, seg = x.to(dev), seg.to(dev)
    before = segment.segment_reduce.launches
    got = segment.segment_reduce(x, seg, V, op)
    assert segment.segment_reduce.launches == before + 1
    exact = op == "max"
    check(got, segment.segment_reduce_plain(x, seg, V, op),
          0 if exact else 1e-4, 0 if exact else 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,C", [("mean", 3), ("max", 64), ("sum", 7)])
def test_segment_broadcast(dev, dtype, op, C):
    rng = np.random.default_rng(1)
    seg, V = segments(rng)
    x = (torch.randn(seg.shape + (C,)) * 10).to(dtype)
    x, seg = x.to(dev), seg.to(dev)
    got = segment.segment_broadcast(x, seg, V, op)
    want = segment.segment_broadcast_plain(x, seg, V, op)
    if op == "max":
        check(got, want, 0, 0)
    else:
        check(got, want, 1e-4, 1e-5 if dtype == torch.float32 else 2 ** -7)
    assert (got[seg == V] == 0).all()


def skewed_segments(rng, P=45001, V=4000):
    """Four batch rows of ascending ids, P not a multiple of any range the
    kernels split the points into.  Row 0: pillars of 1-40 points with
    gaps, runs of one-point pillars, one pillar of 20,000 points (longer
    than several blocks' ranges), a sentinel suffix, empty rows before
    V; row 1: no sentinel suffix, the last pillars one point each; row 2:
    all sentinel; row 3: ``segments``' kind of layout."""
    def pillars(n, first, most):
        sizes = rng.integers(1, most + 1, n)
        return np.repeat(np.arange(first, first + n), sizes)
    row0 = np.concatenate([
        pillars(300, 0, 40) * 2,                  # every other id empty
        np.arange(600, 1600),                     # one-point pillars
        np.full(20000, 1600),                     # one long pillar
        pillars(800, 1601, 40)])[:P - 3000]
    row1 = pillars(2400, 0, 40)[:P - 1500]
    row1 = np.concatenate([row1, row1[-1] + 1 + np.arange(1500)])
    row3 = np.sort(rng.integers(0, V - 20, P))
    row3[int(rng.integers(P // 2, P - 100)):] = V
    seg = np.full((4, P), V, np.int32)
    seg[0, :len(row0)] = row0
    seg[1] = row1
    seg[3] = row3
    return torch.from_numpy(seg), V


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [3, 5, 7, 64, 128])
@pytest.mark.parametrize("which,op", [
    ("reduce", "sum"), ("reduce", "max"), ("broadcast", "sum"),
    ("broadcast", "mean"), ("broadcast", "max")])
def test_segment_kernels_split_by_points(dev, dtype, C, which, op):
    """K1 and K2 at the path's C (3, 64, 128) and at odd C (5, 7) on
    ``skewed_segments``: max exactly, sums and means at the tolerances of
    ``test_segment_reduce`` / ``test_segment_broadcast``, sentinel rows
    exactly 0, one launch counted per call, two launches bitwise equal.
    The payloads are quarters in [-8, 8], so every segment's sum is exact
    in f32 in any order (at most 20,000 x 32 quarters) and the check holds
    how the kernels split and recombine the long pillar, not in which
    order they add: f32 sums of 20,000 normal terms in two orders differ
    by about 2e-3, above the 1e-4 that the pillars of the path's scenes
    (at most a few hundred points) are held to, here and in phase A."""
    rng = np.random.default_rng(10 + C)
    seg, V = skewed_segments(rng)
    x = torch.from_numpy(rng.integers(-32, 33, seg.shape + (C,)) / 4).float()
    x, seg = x.to(dtype).to(dev), seg.to(dev)
    fn = segment.segment_reduce if which == "reduce" else \
        segment.segment_broadcast
    plain = segment.segment_reduce_plain if which == "reduce" else \
        segment.segment_broadcast_plain
    before = fn.launches
    got = fn(x, seg, V, op)
    assert fn.launches == before + 1
    assert torch.equal(got, fn(x, seg, V, op))
    want = plain(x, seg, V, op)
    if op == "max":
        check(got, want, 0, 0)
    elif which == "reduce" or dtype == torch.float32:
        check(got, want, 1e-4, 1e-5)
    else:
        check(got, want, 1e-4, 2 ** -7)
    if which == "broadcast":
        assert (got[seg >= V] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_band_attention_qkv(dev, dtype):
    """Windows up to 150 tokens (more than a 12x12 window holds)."""
    rng = np.random.default_rng(2)
    win, kv = windows(rng)
    B, V = win.shape
    C = 128
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, V, C, generator=g).to(dtype)
    pos = torch.randn(B, V, C, generator=g)
    ws = [torch.randn(C, C, generator=g) * C ** -0.5 if i % 2 == 0
          else torch.randn(C, generator=g) * 0.1 for i in range(6)]
    args = [a.to(dev) for a in (x, pos, *ws, win, kv)] + [8]
    got = attention_qkv.band_attention_qkv(*args)
    check(got, attention_qkv.band_attention_qkv_plain(*args), *TOL[dtype])
    assert (got[win.to(dev) == INT_MAX] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", ffn.KERNEL_WIDTHS, ids=FFN_IDS)
def test_post_attention_block(dev, dtype, C, F):
    B, V = 2, 1000
    g = torch.Generator().manual_seed(1)
    r = lambda *s, scale=0.1: torch.randn(*s, generator=g) * scale
    x, attn = r(B, V, C, scale=1.0).to(dtype), r(B, V, C, scale=1.0).to(dtype)
    ws = [r(C, C), r(C), 1 + r(C), r(C), r(C, F), r(F), r(F, C), r(C),
          1 + r(C), r(C)]
    nv = torch.tensor([613, V], dtype=torch.int32)
    args = [a.to(dev) for a in (x, attn, *ws, nv)]
    got = ffn.post_attention_block(*args)
    check(got, ffn.post_attention_block_plain(*args), *TOL[dtype])
    assert (got[0, 613:] == 0).all()


WGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
WGRAD_FLOOR = {torch.float32: 1e-2, torch.bfloat16: 1e-1}
# bf16 K7's parameter gradients against the plain backward: at
# ``probe_qkv.wgrad_tol`` of (C, D), above WGRAD_TOL's 1e-3.  A token's
# bf16 roundings (of q, k, v, then of ds, p, dq, dk, dv) flip between two
# faithful computations: over ``probe_qkv rule``'s cases (every width,
# [2, 1024] and [4, 8192], three seeds) K7 and the plain backward each
# read up to 1.39e-3 / 1.43e-3 of max(own, 0.1 x largest) from the plain
# backward computed in f64 at the same rounding points at C 384 and 512,
# the plain backward up to 4.76e-3 at C 128 in heads of 8, and up to
# 7.74e-3 (K7) / 6.86e-3 (plain) in heads below 8, so the two may lie up
# to their sum apart; a dropped real row reads 13.3e-3 or more at every
# width (19.3e-3 below 8).


def check_grads(got, want, dtype, n_token, judged_elsewhere=(), tol=None):
    """The first ``n_token`` outputs per token at TOL, atol scaled by each
    row's max(1, largest |want|); each parameter gradient after them
    against ``tol`` (default WGRAD_TOL) of max(its own largest |want|,
    WGRAD_FLOOR x the largest of them).  Outputs whose indices are in
    ``judged_elsewhere`` count towards that largest but are left to the
    caller's own rule."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
    atol, rtol = TOL[dtype]
    for a, b in zip(got[:n_token], want[:n_token]):
        w = b.float()
        bound = atol * w.abs().amax(-1, keepdim=True).clamp_min(1) \
            + rtol * w.abs()
        assert ((a.float() - w).abs() <= bound).all()
    top = max([float(b.float().abs().max()) for b in want[n_token:]],
              default=0.0)
    for i, (a, b) in enumerate(zip(got[n_token:], want[n_token:])):
        assert a.dtype == torch.float32
        if i + n_token in judged_elsewhere:
            continue
        ref = max(float(b.float().abs().max()), WGRAD_FLOOR[dtype] * top)
        err = float((a - b.float()).abs().max())
        assert err <= (tol or WGRAD_TOL[dtype]) * ref, (i, err, ref)


def check_k5_backward(got, args, dtype):
    """K5's backward kernel on ``args`` against its plain version: dx and
    dattn per row at TOL; the ten parameter gradients in f32 by
    ``check_grads``, in bf16 by F5's rule, the kernel's and the plain
    version's each against the f64 computation."""
    want = ffn.post_attention_block_backward_plain(*args)
    if dtype == torch.float32:
        check_grads(got, want, dtype, 2)
        return
    check_grads(got, want, dtype, 2, judged_elsewhere=range(2, 12))
    exact = probe_k5_backward.f64_grads(args)
    bounds = probe_k5_backward.grad_bounds(args)
    for who, grads in (("kernel", got), ("plain", want)):
        shares = probe_k5_backward.rule_shares(grads[2:], exact, bounds)
        assert all(s <= 1 for s in shares), (who, shares)
        low = probe_k5_backward.low_bits_shares(grads[2:])
        assert max(low) <= probe_k5_backward.LOW_BITS_SHARE, (who, low)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [3, 128, 256])
def test_segment_gather(dev, dtype, C):
    """Row copies in 2-, 4- and 16-byte units: exact."""
    rng = np.random.default_rng(3)
    seg, V = segments(rng)
    table = torch.randn(seg.shape[0], V, C).to(dtype).to(dev)
    seg = seg.to(dev)
    before = segment.segment_gather.launches
    got = segment.segment_gather(table, seg)
    assert segment.segment_gather.launches == before + 1
    check(got, segment.segment_gather_plain(table, seg), 0, 0)


def grads_on(x, fn, g):
    """x.grad of sum(fn(x) * g), from a fresh leaf."""
    x = x.detach().clone().requires_grad_()
    fn(x).backward(g)
    return x.grad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which,op,C", [
    ("reduce", "sum", 3), ("reduce", "max", 128),
    ("broadcast", "max", 64), ("broadcast", "mean", 3),
    ("broadcast", "sum", 7)])
def test_segment_gradients(dev, dtype, which, op, C):
    """The Functions' backward on the card (K1 gather, K2 sum / mean)
    against the same backward on the CPU (plain versions).  Payloads are
    small integers, so maxima tie; every tie gets the whole cotangent."""
    rng = np.random.default_rng(4)
    seg, V = segments(rng)
    x = torch.from_numpy(rng.integers(-3, 4, seg.shape + (C,))).to(dtype)
    fn = segment.segment_reduce if which == "reduce" else \
        segment.segment_broadcast
    gshape = (seg.shape[0], V, C) if which == "reduce" else x.shape
    g = torch.randn(gshape)
    if which == "broadcast":
        g = g.to(dtype)
    want = grads_on(x, lambda t: fn(t, seg, V, op), g)
    counts = (segment.segment_gather.launches,
              segment.segment_broadcast.launches)
    got = grads_on(x.to(dev), lambda t: fn(t, seg.to(dev), V, op),
                   g.to(dev))
    if which == "reduce":
        assert segment.segment_gather.launches == counts[0] + 1
    else:
        assert segment.segment_broadcast.launches == counts[1] + 2
    exact = which == "reduce"
    check(got.cpu(), want, 0 if exact else 1e-4,
          0 if exact else (1e-5 if dtype == torch.float32 else 2 ** -7))


def ffn_case(dtype, dev, B=2, V=1000, C=ffn.KERNEL_C, F=ffn.KERNEL_F):
    g = torch.Generator().manual_seed(5)
    r = lambda *s, scale=0.1: torch.randn(*s, generator=g) * scale
    x, attn = r(B, V, C, scale=1.0).to(dtype), r(B, V, C, scale=1.0).to(dtype)
    ws = [r(C, C), r(C), 1 + r(C), r(C), r(C, F), r(F), r(F, C), r(C),
          1 + r(C), r(C)]
    nv = torch.tensor([613, V], dtype=torch.int32)
    dy = r(B, V, C, scale=1.0).to(dtype)
    return [a.to(dev) for a in (x, attn, *ws, nv, dy)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", ffn.KERNEL_WIDTHS, ids=FFN_IDS)
def test_post_attention_block_backward(dev, dtype, C, F):
    args = ffn_case(dtype, dev, C=C, F=F)
    before = ffn.post_attention_block_backward.launches
    got = ffn.post_attention_block_backward(*args)
    assert ffn.post_attention_block_backward.launches == before + 1
    check_k5_backward(got, args, dtype)
    assert (got[0][0, 613:] == 0).all() and (got[1][0, 613:] == 0).all()


@pytest.mark.parametrize("B,V,nv", [(1, 1000, (1000,)), (1, 777, (500,)),
                                    (4, 1000, (613, 0, 1000, 64)),
                                    (4, 8192, (8192, 2500, 8192, 7001))])
@pytest.mark.parametrize("C,F", ffn.KERNEL_WIDTHS, ids=FFN_IDS)
def test_post_attention_block_bf16(dev, B, V, nv, C, F):
    """The bf16 forward on the tensor cores against the plain version, per
    row: nv < V, nv = 0 for a sample, V not a multiple of the token tile
    (64, 32 or 16 by width), B = 1 and 4; one launch a call; rows past nv
    exactly 0; two launches bitwise equal (no atomics)."""
    args = ffn_case(torch.bfloat16, dev, B=B, V=V, C=C, F=F)[:13]
    args[12] = torch.tensor(nv, dtype=torch.int32, device=dev)
    before = ffn.post_attention_block.launches
    got = ffn.post_attention_block(*args)
    assert ffn.post_attention_block.launches == before + 1
    assert got.dtype == torch.bfloat16
    check_grads((got,), (ffn.post_attention_block_plain(*args),),
                torch.bfloat16, 1)
    past = torch.arange(V, device=dev)[None, :] >= args[12][:, None]
    assert (got[past] == 0).all()
    assert torch.equal(got, ffn.post_attention_block(*args))


def wgrad_rows(dev, B, V, nv, seed=7, C=ffn.KERNEL_C, F=ffn.KERNEL_F):
    """bf16 token rows of the weight-gradient pass, [B, V, k] each; the
    attn rows past ``nv`` hold NaN (the pass must skip them, not rely on
    zero cotangents)."""
    g = torch.Generator().manual_seed(seed)
    rows = [torch.randn(B, V, k, generator=g).to(torch.bfloat16)
            for k in (C, C, C, F, F, C)]
    nv = torch.tensor(nv, dtype=torch.int32)
    past = torch.arange(V)[None, :] >= nv[:, None]
    rows[0][past] = float("nan")
    return [t.to(dev) for t in rows], nv.to(dev)


@pytest.mark.parametrize("B,V,nv", [(4, 20480, (20480, 19000, 20480, 20480)),
                                    (4, 8192, (8192, 8192, 3001, 8192))])
@pytest.mark.parametrize("C,F", ffn.KERNEL_WIDTHS, ids=FFN_IDS)
def test_weight_grads_alone(dev, B, V, nv, C, F):
    """The bf16 backward's weight-gradient pass (split-K over token
    chunks, mma.sync) against f32 products of the real rows, at the
    decoder and encoder shapes: 1e-4 of each gradient's largest value (the
    same f32 sums in another order)."""
    rows, nv_t = wgrad_rows(dev, B, V, nv, C=C, F=F)
    keep = (torch.arange(V, device=dev)[None, :] < nv_t[:, None])[..., None]
    flat = lambda t: torch.where(keep, t.float(), 0.0).reshape(-1, t.shape[-1])
    attn, dx, xm, da1, h, dz2 = rows
    before = ffn.weight_grads.launches
    got = ffn.weight_grads(*rows, nv_t)
    assert ffn.weight_grads.launches == before + 1
    for a, (p, d) in zip(got, ((attn, dx), (xm, da1), (h, dz2))):
        want = flat(p).t() @ flat(d)
        assert a.dtype == torch.float32 and a.shape == want.shape
        assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("B,V,nv", [(1, 1000, (1000,)), (1, 777, (500,)),
                                    (4, 1000, (613, 0, 1000, 64)),
                                    (4, 8192, (8192, 2500, 8192, 7001))])
@pytest.mark.parametrize("C,F", ffn.KERNEL_WIDTHS, ids=FFN_IDS)
def test_post_attention_block_backward_bf16(dev, B, V, nv, C, F):
    """The bf16 backward on the tensor cores against the plain backward:
    nv < V, nv = 0 for a sample, V not a multiple of the token tile, B
    = 1 and 4; rows past nv are 0 in dx and dattn."""
    args = ffn_case(torch.bfloat16, dev, B=B, V=V, C=C, F=F)
    args[12] = torch.tensor(nv, dtype=torch.int32, device=dev)
    got = ffn.post_attention_block_backward(*args)
    check_k5_backward(got, args, torch.bfloat16)
    past = torch.arange(V, device=dev)[None, :] >= args[12][:, None]
    assert (got[0][past] == 0).all() and (got[1][past] == 0).all()


@pytest.mark.parametrize("C,F", ffn.KERNEL_WIDTHS, ids=FFN_IDS)
def test_post_attention_block_backward_bf16_fails_a_dropped_token(dev, C,
                                                                  F):
    """F5's rule catches a planted fault: the kernel's gradients with one
    token's terms dropped (its cotangent zeroed,
    ``probe_k5_backward.dropped_token``) break it in each of the ten, at
    the one-sample case (V 777, nv 500)."""
    args = [t.to(dev) for t in probe_k5_backward.test_case(C, F, 1, 777,
                                                           (500,))]
    exact = probe_k5_backward.f64_grads(args)
    bounds = probe_k5_backward.grad_bounds(args)
    fault = ffn.post_attention_block_backward(
        *probe_k5_backward.dropped_token(args))
    shares = probe_k5_backward.rule_shares(fault[2:], exact, bounds)
    assert all(s > 1 for s in shares), shares


@pytest.mark.parametrize("C,F", ffn.KERNEL_WIDTHS, ids=FFN_IDS)
def test_post_attention_block_backward_is_deterministic(dev, C, F):
    """Two bf16 calls on the same inputs give bitwise equal dx, dattn and
    ten gradients (no atomics; partials summed in a fixed order)."""
    args = ffn_case(torch.bfloat16, dev, B=4, V=4000, C=C, F=F)
    args[12] = torch.tensor([4000, 1234, 0, 3999], dtype=torch.int32,
                            device=dev)
    a = ffn.post_attention_block_backward(*args)
    b = ffn.post_attention_block_backward(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("C,F", [(128, 1024), (128, 320), (256, 2048),
                                 (256, 128), (512, 2560), (640, 5120),
                                 (1152, 2304)])
def test_k5_wrappers_refuse_widths_outside_the_set(dev, C, F):
    """F of 8 C (at C 128 and 640), F not a multiple of 128, (256,
    2048), F below C, F of 5 C at C 512, and C 1152: K5's forward,
    backward and weight-gradient wrappers raise on a CUDA tensor rather
    than run a plain version."""
    args = ffn_case(torch.bfloat16, dev, B=1, V=64, C=C, F=F)
    with pytest.raises(ValueError):
        ffn.post_attention_block(*args[:13])
    with pytest.raises(ValueError):
        ffn.post_attention_block_backward(*args)
    x, nv = args[0], args[12]
    h = torch.zeros(1, 64, F, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        ffn.weight_grads(x, x, x, h, h, x, nv)


def attention_case(dtype, dev, C=128):
    rng = np.random.default_rng(2)
    win, kv = windows(rng)
    B, V = win.shape
    g = torch.Generator().manual_seed(6)
    x = torch.randn(B, V, C, generator=g).to(dtype)
    pos = torch.randn(B, V, C, generator=g)
    ws = [torch.randn(C, C, generator=g) * C ** -0.5 if i % 2 == 0
          else torch.randn(C, generator=g) * 0.1 for i in range(6)]
    dout = torch.randn(B, V, C, generator=g).to(dtype)
    return [a.to(dev) for a in (x, pos, *ws, win, kv)], dout.to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", QKV_HEADS, ids=QKV_HEAD_IDS)
def test_band_attention_qkv_backward(dev, dtype, heads):
    """K7 from the forward kernel's statistics against the plain backward
    (which recomputes its softmax), windows up to 150 tokens, at every
    width K7 takes: dx per row, the parameter gradients by
    ``check_grads`` (in bf16 at ``probe_qkv.wgrad_tol`` of the width),
    the key bias's by F3's rule at the dtype's unit roundoff (both K7's
    and the plain version's within ``probe_qkv.dbk_bound`` of 0, as the
    CPU tests hold it: rounding noise of an analytically zero sum, which
    the f32 floor of ``check_grads`` held at the noise, 1.02 of it at C
    384 in one head); padding rows of dx 0; one launch a
    call, two launches bitwise equal; K7 on a cotangent with one real
    row dropped (``probe_qkv.dropped_rows``) fails the parameter
    gradients' rule.  In bf16 the parameter gradients but the key bias's
    (rounding noise of an analytically zero sum, F3's) also carry more
    than bf16's precision, the kernel's and the plain version's: at most
    ``probe_k5_backward.LOW_BITS_SHARE`` of a gradient's elements end in
    16 zero bits; the kernel's gradients rounded to bf16 (stored in f32),
    a planted fault, fail that rule."""
    H, D = heads
    args, dout = attention_case(dtype, dev, C=H * D)
    out, lse = attention_qkv._forward(*args, H, stats=True)
    before = attention_qkv.band_attention_qkv_backward.launches
    got = attention_qkv.band_attention_qkv_backward(*args, H, out, lse, dout)
    assert attention_qkv.band_attention_qkv_backward.launches == before + 1
    want = attention_qkv.band_attention_qkv_backward_plain(*args, H, out,
                                                          dout)
    i_bk = probe_qkv.GRAD_NAMES.index("bk") + 1
    tol = probe_qkv.wgrad_tol(H * D, D) if dtype == torch.bfloat16 else None
    elsewhere = (i_bk,)
    check_grads(got, want, dtype, 1, judged_elsewhere=elsewhere, tol=tol)
    bound = probe_qkv.dbk_bound(
        attention_qkv.attention_grads_plain(*args, H, out, dout)[1], dtype)
    for dbk in (got[i_bk], want[i_bk]):
        assert (dbk.abs() <= bound).all(), float((dbk.abs() / bound).max())
    if dtype == torch.bfloat16:
        low = lambda gs: probe_k5_backward.low_bits_shares(
            [g for i, g in enumerate(gs, 1) if i != i_bk])
        for who, gs in (("kernel", got), ("plain", want)):
            assert max(low(gs[1:])) <= probe_k5_backward.LOW_BITS_SHARE, \
                (who, low(gs[1:]))
        rounded = [g.bfloat16().float() for g in got[1:]]
        assert max(low(rounded)) > probe_k5_backward.LOW_BITS_SHARE
    dropped = attention_qkv.band_attention_qkv_backward(
        *args, H, out, lse, probe_qkv.dropped_rows(dout, args[8], 1))
    with pytest.raises(AssertionError):
        check_grads(dropped[1:], want[1:], dtype, 0,
                    judged_elsewhere=tuple(i - 1 for i in elsewhere), tol=tol)
    assert (got[0][args[8] == INT_MAX] == 0).all()
    again = attention_qkv.band_attention_qkv_backward(*args, H, out, lse,
                                                      dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_band_attention_qkv_backward_one_sample(dev):
    """bf16 K7 at one sample of 777 tokens (V not a multiple of the
    64-row tile), windows of up to 144 tokens (``probe_qkv.k7_case``).

    dx and every parameter gradient but the key bias's by ``check_grads``.
    The key bias's gradient dbk is analytically 0: softmax ignores a
    shift shared by a row's keys, so sum_j ds_ij = 0 and sum_j dk_j =
    sum_i q_i sum_j ds_ij = 0.  Both K7 and the plain backward compute it
    as sum_j rt(dk_j), the f32 dk_j rounded to bf16 (rt) and summed in
    f32, so what they return is rounding noise, and at one sample the two
    noises differ by more than ``check_grads`` allows (1.628 of its bound;
    the plain backward on projections summed in f64, a closer computation
    of the same function, 1.171: ``probe_qkv grads``).  So each is held to
    the exact value, 0, by the forward-error bound of the sum it
    computes.  Per channel c: |rt(d) - d| <= 2^-8 |d| (bf16 keeps 8
    significant bits, rounded to nearest), and a sum of n f32 terms in
    any order is off by at most (n - 1) 2^-24 sum |terms| (to first
    order), so

        |sum_j rt(dk_jc)| <= |sum_j dk_jc| + 2^-8 sum_j |dk_jc|
                             + (n - 1) 2^-24 sum_j |rt(dk_jc)|
                          <= (2^-8 + n 2^-24) sum_j |dk_jc|,

    taking sum_j dk_jc = 0, n = B x V (every row is a term; padding rows
    add 0) and the f32 dk of the plain backward (``attention_grads_plain``)
    for dk (``probe_qkv.dbk_bound``).  A dbk taken from dq's or dv's
    column sums fails it (``probe_qkv grads``)."""
    args, dout = probe_qkv.k7_case(1, 777)
    out, lse = attention_qkv._forward(*args, 8, stats=True)
    got = attention_qkv.band_attention_qkv_backward(*args, 8, out, lse,
                                                    dout)
    want = attention_qkv.band_attention_qkv_backward_plain(*args, 8, out,
                                                          dout)
    i_bk = probe_qkv.GRAD_NAMES.index("bk") + 1
    check_grads(got, want, torch.bfloat16, 1, judged_elsewhere=(i_bk,))
    bound = probe_qkv.dbk_bound(
        attention_qkv.attention_grads_plain(*args, 8, out, dout)[1])
    for dbk in (got[i_bk], want[i_bk]):
        assert (dbk.abs() <= bound).all(), float((dbk.abs() / bound).max())
    assert (got[0][args[8] == INT_MAX] == 0).all()


def projection_case(dev, B, V, seed=8, C=128):
    """bf16 x and a window layout with a padding suffix; f32 pos and
    weights (the wrappers cast them); three bf16 cotangents."""
    win, _ = windows(np.random.default_rng(seed), B=B, V=V)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, V, C, generator=g).to(torch.bfloat16)
    pos = torch.randn(B, V, C, generator=g)
    ws = [torch.randn(C, C, generator=g) * C ** -0.5 if i % 2 == 0
          else torch.randn(C, generator=g) * 0.1 for i in range(6)]
    ds = [torch.randn(B, V, C, generator=g).to(torch.bfloat16)
          for _ in range(3)]
    return [a.to(dev) for a in (x, pos, *ws, win)], [d.to(dev) for d in ds]


@pytest.mark.parametrize("B,V", [(1, 777), (2, 1024), (4, 8192)])
@pytest.mark.parametrize("C", attention_qkv.KERNEL_CHANNELS)
def test_qkv_project_bf16(dev, C, B, V):
    """K6's projections on the tensor cores against the plain version at
    the bf16 bound, per row (a block owns a 128-, 64- or 32-column slice
    of the three products at C 128, 256 or 384 and 512, 32-row tiles at
    C 512; a 64-row tile and a 64-column slice with the contraction
    streamed at C 640, 768 and 1024); padding rows exactly 0; V not a multiple of the tile; one
    launch a call, two launches bitwise equal."""
    args, _ = projection_case(dev, B, V, C=C)
    before = attention_qkv.qkv_project.launches
    got = attention_qkv.qkv_project(*args)
    assert attention_qkv.qkv_project.launches == before + 1
    check_grads(got, attention_qkv.qkv_project_plain(*args), torch.bfloat16,
                3)
    pad = args[8] == INT_MAX
    assert pad.any() and all((t[pad] == 0).all() for t in got)
    again = attention_qkv.qkv_project(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,V", [(1, 777), (2, 1024), (4, 8192)])
@pytest.mark.parametrize("C", attention_qkv.KERNEL_CHANNELS)
def test_qkv_project_backward_bf16(dev, C, B, V):
    """The projections' backward (dx on the tensor cores, the weight
    gradients split over SM-sized row chunks, ``wgrad_chunk_rows``)
    against the plain version: dx per row, the parameter gradients by the
    rule of the other backward kernels; one launch a call, two launches
    bitwise equal; at C 128, 256, 384, 512, 640, 768 and 1024 (1, 4, 9,
    16, 25, 36 and 64 output tiles of 128 x 128 a product; dx streams its
    contraction above 512)."""
    args, ds = projection_case(dev, B, V, C=C)
    x, pos, wq, _, wk, _, wv, _, _ = args
    before = attention_qkv.qkv_project_backward.launches
    got = attention_qkv.qkv_project_backward(x, pos, wq, wk, wv, *ds)
    assert attention_qkv.qkv_project_backward.launches == before + 1
    want = attention_qkv.qkv_project_backward_plain(x, pos, wq, wk, wv, *ds)
    check_grads(got, want, torch.bfloat16, 1)
    again = attention_qkv.qkv_project_backward(x, pos, wq, wk, wv, *ds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_qkv_projections_take_bf16_only(dev):
    """f32 K6 and K7 keep their CUDA-core kernels, so the projections'
    kernels take bf16 alone."""
    args, ds = projection_case(dev, 1, 256)
    x32 = args[0].float()
    with pytest.raises(ValueError):
        attention_qkv.qkv_project(x32, *args[1:])
    with pytest.raises(ValueError):
        attention_qkv.qkv_project_backward(x32, args[1], *args[2:8:2],
                                           *[d.float() for d in ds])


@pytest.mark.parametrize("C,H", [(640, 160), (768, 3), (1024, 4),
                                 (1024, 256), (640, 1), (1152, 18)])
def test_qkv_wrappers_refuse_widths_outside_the_set(dev, C, H):
    """C 640 in heads of 4 or in one head of 640, C 768 in heads of
    256, C 1024 in heads of 256 or of 4, and C 1152 in heads of 64: K6
    and K7 raise on a CUDA tensor rather than run a plain version, and at
    C 1152 (a C outside KERNEL_CHANNELS; they see no heads) so do the
    projections."""
    x = torch.randn(1, 64, C, device=dev)
    win = torch.zeros(1, 64, dtype=torch.int32, device=dev)
    kv = torch.ones(1, 64, dtype=torch.bool, device=dev)
    w, b = torch.randn(C, C, device=dev), torch.randn(C, device=dev)
    qkv = (x, x, w, b, w, b, w, b, win, kv, H)
    with pytest.raises(ValueError):
        attention_qkv.band_attention_qkv(*qkv)
    with pytest.raises(ValueError):
        attention_qkv.band_attention_qkv_backward(
            *qkv, x, torch.zeros(1, 64, H, device=dev), x)
    if C not in attention_qkv.KERNEL_CHANNELS:
        xb = x.bfloat16()
        with pytest.raises(ValueError):
            attention_qkv.qkv_project(xb, *qkv[1:9])
        with pytest.raises(ValueError):
            attention_qkv.qkv_project_backward(xb, x, w, w, w, xb, xb, xb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", QKV_HEADS, ids=QKV_HEAD_IDS)
def test_band_attention_qkv_statistics(dev, dtype, heads):
    """K6 at every width it takes (the scale folded into q at D = 16 and
    64, on the f32 score at 32), windows up to 150 tokens: under grad
    the output is the one without statistics and the plain one, its
    log-sum-exp per row and head the plain one (0 on padding rows and
    rows without a valid key); padding rows exactly 0; one launch a
    call, two launches bitwise equal."""
    H, D = heads
    args, _ = attention_case(dtype, dev, C=H * D)
    before = attention_qkv.band_attention_qkv.launches
    out, lse = attention_qkv._forward(*args, H, stats=True)
    assert attention_qkv.band_attention_qkv.launches == before + 1
    assert lse.shape == out.shape[:2] + (H,) and lse.dtype == torch.float32
    check(out, attention_qkv._forward(*args, H, stats=False)[0], 0, 0)
    check(out, attention_qkv.band_attention_qkv_plain(*args, H), *TOL[dtype])
    check(lse, attention_qkv.band_attention_qkv_lse_plain(*args, H),
          *TOL[dtype])
    assert (out[args[8] == INT_MAX] == 0).all()
    again = attention_qkv._forward(*args, H, stats=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def test_autograd_launches_the_backward_kernels(dev):
    """One encoder-layer-shaped chain under grad: K6 then K5 forward,
    K5-backward then K7 backward, each once; without grad, no statistics
    and no backward."""
    args, _ = attention_case(torch.bfloat16, dev)
    x = args[0].detach().requires_grad_()
    fargs = ffn_case(torch.bfloat16, dev, V=x.shape[1])
    ws = [w.requires_grad_() for w in fargs[2:12]]
    counts = lambda: (attention_qkv.band_attention_qkv.launches,
                      attention_qkv.band_attention_qkv_backward.launches,
                      ffn.post_attention_block.launches,
                      ffn.post_attention_block_backward.launches)
    before = counts()
    a = attention_qkv.band_attention_qkv(x, *args[1:], 8)
    y = ffn.post_attention_block(x, a, *ws, fargs[12])
    y.float().square().sum().backward()
    assert [c - b for c, b in zip(counts(), before)] == [1, 1, 1, 1]
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    assert all(w.grad.dtype == torch.float32 for w in ws)
    with torch.no_grad():
        before = counts()
        attention_qkv.band_attention_qkv(x, *args[1:], 8)
        assert [c - b for c, b in zip(counts(), before)] == [1, 0, 0, 0]


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 64, 32, device=dev)
    win = torch.zeros(1, 64, dtype=torch.int32, device=dev)
    kv = torch.ones(1, 64, dtype=torch.bool, device=dev)
    w, b = torch.randn(32, 32, device=dev), torch.randn(32, device=dev)
    with pytest.raises(ValueError):       # C = 32: the kernel takes 128
        attention_qkv.band_attention_qkv(x, x, w, b, w, b, w, b, win, kv, 4)
    seg = torch.zeros(1, 64, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):       # int64 ids
        segment.segment_reduce(x, seg, 4, "sum")
    with pytest.raises(ValueError):       # non-contiguous
        segment.segment_reduce(x.transpose(1, 2), seg.int()[:, :32], 4, "sum")


def slot_case(rng, dev, B=2, P=20000, V=1500, S=128):
    """Ascending pillar ids (runs of up to 40 points, some pillars of one
    slot, so a lane sums over chunks), slots in [0, S), a zeroed sentinel
    suffix, rows past the last id empty."""
    seg = np.sort(rng.integers(0, V - 50, (B, P)), axis=1).astype(np.int32)
    seg[:, 100:300] = seg[:, 100:101]                 # one long pillar
    slot = rng.integers(0, S, (B, P)).astype(np.int32)
    slot[:, 100:300] = 7                              # 200 points, one slot
    vals = rng.normal(0, 10, (B, P, 4)).astype(np.float32)
    vals[..., 3] = 1.0
    for b in range(B):
        n = int(rng.integers(P // 2, P - 1000))
        seg[b, n:] = V
        vals[b, n:] = 0
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(vals), t(slot), t(seg), S, V


@pytest.mark.parametrize("S", [32, 64, 96, 128])
def test_slot_outer_segment_sum(dev, S):
    """K3 against index_add_: counts exact, sums within their f32 order
    bound, rows past the ids and the sentinel suffix left out, and two
    launches bitwise equal (no atomics)."""
    vals, slot, seg, S, V = slot_case(np.random.default_rng(8), dev, S=S)
    before = targets.slot_outer_segment_sum.launches
    got = targets.slot_outer_segment_sum(vals, slot, seg, S, V)
    assert targets.slot_outer_segment_sum.launches == before + 1
    want = targets.slot_outer_segment_sum_plain(vals, slot, seg, S, V)
    assert got.shape == want.shape == (seg.shape[0], V, S, 4)
    check(got[..., 3], want[..., 3], 0, 0)
    mag = targets.slot_outer_segment_sum_plain(vals.abs(), slot, seg, S, V)
    bound = 2 ** -23 * want[..., 3:] * mag
    assert ((got - want).abs() <= bound).all()
    assert int(got[..., 3].sum()) == int((seg < V).sum())
    assert (got[:, V - 50:] == 0).all()
    assert torch.equal(got, targets.slot_outer_segment_sum(vals, slot, seg,
                                                           S, V))


def expand_case(rng, dev, B=2, V=3000, C=13, n_cells=160000):
    feats = rng.normal(0, 100, (B, V, C)).astype(np.float32)
    key = np.full((B, V), n_cells, np.int32)
    for b in range(B):
        n = int(rng.integers(V // 2, V))
        key[b, :n] = np.sort(rng.choice(n_cells, n, replace=False))
        key[b, n:] = n_cells
        feats[b, n:] = 0
    key[0, 0] = 0                      # the first and the last cell
    key[1, int((key[1] < n_cells).sum()) - 1] = n_cells - 1
    return torch.from_numpy(feats).to(dev), torch.from_numpy(key).to(dev), \
        n_cells


def test_expand_rows(dev):
    """K4 against its plain version: exact everywhere, the sentinel row
    n_cells 0."""
    feats, key, n = expand_case(np.random.default_rng(9), dev)
    before = targets.expand_rows.launches
    got = targets.expand_rows(feats, key, n)
    assert targets.expand_rows.launches == before + 1
    check(got, targets.expand_rows_plain(feats, key, n), 0, 0)
    assert (got[:, n] == 0).all()
    assert torch.equal(got[0, 0], feats[0, 0])


def test_targets_on_the_card_match_the_cpu(dev):
    """``compute_targets_batch`` through K3 and K4 against the CPU's plain
    versions at ``tiny_pretrain_config()``: occupancy exact, centroids at
    1e-5, the normals' axes at |cos| > 1 - 1e-4 where the two smallest
    eigenvalues are apart."""
    from geomae_tpu_torch.config import tiny_pretrain_config
    from geomae_tpu_torch.models.mae import compute_targets_batch
    from geomae_tpu_torch.ops.voxelize import build_scene_batch
    from geomae_tpu_torch.train.pretrain import synthetic_batch

    cfg = tiny_pretrain_config()
    batch = synthetic_batch(cfg, 2, seed=1, device="cpu")
    out = {}
    for d in (dev, torch.device("cpu")):
        scene = build_scene_batch(batch["points"].to(d),
                                  batch["point_valid"].to(d), cfg.voxel,
                                  cfg.caps.max_voxels)
        counts = (targets.slot_outer_segment_sum.launches,
                  targets.expand_rows.launches)
        out[d.type] = compute_targets_batch(scene, cfg)
        launched = (targets.slot_outer_segment_sum.launches - counts[0],
                    targets.expand_rows.launches - counts[1])
        assert launched == ((1, 1) if d.type == "cuda" else (0, 0))
    g, c = out["cuda"], out["cpu"]
    for name in ("low_occ", "med_occ"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name))
    for name in ("low_tgt", "med_tgt", "centroid_top"):
        check(getattr(g, name).cpu(), getattr(c, name), 1e-5, 1e-5)
    cv = c.curv
    sel = (cv[..., 1] - cv[..., 2] > 1e-2 * cv[..., 0]) & (cv[..., 0] > 0)
    cos = (g.normal.cpu() * c.normal).sum(-1)[sel]
    assert sel.any() and (cos.abs() > 1 - 1e-4).all()


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_tiny_train_step_on_the_card(dev, kind):
    """One step of the ``--tiny`` presets (32 in 4 heads, FFN 64) on the
    card: the SST resolves to its plain routes there as on the CPU, so no
    SST kernel launches while the VFE's segment kernels do; the losses are
    finite and match the CPU's step from the same weights, batch and mask
    at 1e-3 relative (f32 sums in another order), and every parameter
    moves."""
    from geomae_tpu_torch.config import (tiny_finetune_config,
                                         tiny_pretrain_config)
    from geomae_tpu_torch.train import finetune, pretrain

    mod = pretrain if kind == "pretrain" else finetune
    cfg = tiny_pretrain_config() if kind == "pretrain" \
        else tiny_finetune_config()
    host = mod.synthetic_batch(cfg, 2, seed=3, device="cpu")
    keep = None
    if kind == "pretrain":
        keep = pretrain.targets_and_mask(
            cfg, host, torch.Generator().manual_seed(5))[2]
    sst = (attention.band_attention_fused, ffn.post_attention_block,
           ffn.post_attention_block_backward, attention_qkv.band_attention_qkv)
    losses = {}
    for d in (dev, torch.device("cpu")):
        state = mod.init_state(cfg, d, torch.Generator().manual_seed(1))
        layer = state.model.backbone.encoder_blocks[0].encoder_list[0]
        assert (layer.win_attn.route, layer.fused) == ("einsum", False)
        before = [p.detach().clone() for p in state.model.parameters()]
        counts = [f.launches for f in sst], segment.segment_reduce.launches
        batch = {k: v.to(d) for k, v in host.items()}
        step = mod.make_train_step(cfg)
        if kind == "pretrain":
            state, out = step(state, batch, keep=keep.to(d))
        else:
            state, out = step(state, batch)
        assert [f.launches for f in sst] == counts[0]
        assert (segment.segment_reduce.launches > counts[1]) == \
            (d.type == "cuda")
        assert all(torch.isfinite(v).all() for v in out.values())
        assert all(not torch.equal(a, p.detach()) for a, p in
                   zip(before, state.model.parameters()))
        losses[d.type] = {k: float(v) for k, v in out.items()}
    for k, v in losses["cpu"].items():
        assert losses["cuda"][k] == pytest.approx(v, rel=1e-3, abs=1e-6), k


def encoder_tokens(dev, B=2, seed=0):
    """The pretrain encoder's window layout: full-width clouds, the random
    30 % of their pillars compacted into 8,192 visible slots."""
    from geomae_tpu_torch.config import geomae_pretrain_nus
    from geomae_tpu_torch.models.mae import (encoder_shift_data,
                                             sample_mask, visible_rows)
    from geomae_tpu_torch.ops.voxelize import build_scene_batch
    from geomae_tpu_torch.train.pretrain import synthetic_batch

    cfg = geomae_pretrain_nus()
    b = synthetic_batch(cfg, B, seed=seed, device=dev)
    table = build_scene_batch(b["points"], b["point_valid"], cfg.voxel,
                              cfg.caps.max_voxels).table
    keep = sample_mask(torch.Generator(device=dev).manual_seed(seed),
                       table.valid, cfg.mae.random_mask_ratio)
    vis_raw, _, vis_valid = visible_rows(keep, cfg.caps.max_visible)
    layer = encoder_shift_data(table, vis_raw, vis_valid, cfg)["layers"][1]
    assert layer["win_id"].shape == (B, cfg.caps.max_visible)
    return layer


@pytest.mark.parametrize("dtype", DTYPES)
def test_sst_kernels_at_the_encoder_shape(dev, dtype):
    """K6 (with statistics), K5, K7 and K5's backward on the visible
    tokens' layout, each against its plain version."""
    lay = encoder_tokens(dev)
    B, V = lay["win_id"].shape
    C, F = ffn.KERNEL_C, ffn.KERNEL_F
    g = torch.Generator(device=dev).manual_seed(7)
    r = lambda *s, scale=0.1: torch.randn(*s, generator=g, device=dev) * scale
    x, a, d = (r(B, V, C, scale=1.0).to(dtype) for _ in range(3))
    ws = [r(C, C, scale=C ** -0.5) if i % 2 == 0 else r(C) for i in range(6)]
    qkv = (x, lay["pos_sorted"], *ws, lay["win_id"], lay["key_valid_sorted"],
           8)
    out, lse = attention_qkv._forward(*qkv, stats=True)
    check(out, attention_qkv.band_attention_qkv_plain(*qkv), *TOL[dtype])
    check(lse, attention_qkv.band_attention_qkv_lse_plain(*qkv), *TOL[dtype])
    check_grads(attention_qkv.band_attention_qkv_backward(*qkv, out, lse, d),
                attention_qkv.band_attention_qkv_backward_plain(*qkv, out,
                                                                d),
                dtype, 1)
    fw = [r(C, C), r(C), 1 + r(C), r(C), r(C, F), r(F), r(F, C), r(C),
          1 + r(C), r(C)]
    block = (x, a, *fw, lay["extent"])
    check(ffn.post_attention_block(*block),
          ffn.post_attention_block_plain(*block), *TOL[dtype])
    check_k5_backward(ffn.post_attention_block_backward(*block, d),
                      (*block, d), dtype)


def expand_spans(n_cells, V=1500, C=13, B=3, seed=15):
    """K4's edge cases at B = 3, C = 13 (so batch rows 1 and 2 start 4 and
    8 bytes past a 16-byte boundary): sample 0 occupies the whole
    512-cell span [512, 1024) and the first cell, with spans of no key
    after them; sample 1
    random cells with the last one; sample 2 is all sentinel."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 100, (B, V, C)).astype(np.float32)
    key = np.full((B, V), n_cells, np.int32)
    full = np.arange(512, 1024)[:max(0, min(512, n_cells - 512))]
    k0 = np.concatenate([[0], full])
    key[0, :k0.size] = k0
    k1 = np.sort(rng.choice(n_cells - 1, min(n_cells - 1, V // 3),
                            replace=False))
    k1 = np.append(k1, n_cells - 1) if n_cells > 1 else np.array([0])
    key[1, :k1.size] = k1
    feats[key == n_cells] = 0
    t = lambda a: torch.from_numpy(a).cuda()
    return t(feats), t(key)


@pytest.mark.parametrize("n_cells,V,C", [(1, 1500, 13), (600, 1500, 13),
                                         (1024, 1500, 13), (5000, 1500, 13),
                                         (160000, 70000, 13),
                                         (5000, 1500, 30)])
def test_expand_rows_spans(dev, n_cells, V, C):
    """K4 on spans with no key, a fully occupied span and an all-sentinel
    sample, unaligned batch rows, a probe step longer than the block
    (V = 70,000: a bracket of more than 256 rows to scan), and another
    channel count (C = 30): exact against the plain version, row n_cells
    0, one launch."""
    feats, key = expand_spans(n_cells, V, C)
    before = targets.expand_rows.launches
    got = targets.expand_rows(feats, key, n_cells)
    assert targets.expand_rows.launches == before + 1
    check(got, targets.expand_rows_plain(feats, key, n_cells), 0, 0)
    assert (got[:, n_cells] == 0).all() and (got[2] == 0).all()
    assert torch.equal(got[0, 0], feats[0, 0])


def test_target_wrappers_refuse_what_the_kernels_do_not_take(dev):
    vals = torch.zeros(1, 64, 4, device=dev)
    ids = torch.zeros(1, 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):       # 100 slots
        targets.slot_outer_segment_sum(vals, ids, ids, 100, 4)
    with pytest.raises(ValueError):       # int64 ids
        targets.slot_outer_segment_sum(vals, ids, ids.long(), 128, 4)
    with pytest.raises(ValueError):       # bf16 payload
        targets.expand_rows(vals.bfloat16(), ids, 10)


def band_case(dtype, dev, win, kv, seed=10, heads=SHIPPED):
    """q, k, v and a cotangent [B, V, H, D] from a seed, on ``dev``; the
    shipped 8 heads of 16 unless ``heads`` = (H, D) says otherwise."""
    B, V = win.shape
    g = torch.Generator().manual_seed(seed)
    shape = (B, V, *heads)
    q, k, v, d = (torch.randn(shape, generator=g).to(dtype).to(dev)
                  for _ in range(4))
    return q, k, v, win.to(dev), kv.to(dev), d


WINDOW_SIZES = (1, 63, 64, 65, 20, 144, 300)    # the 20-token one: no key


def sized_windows(V=768):
    """(win_id, key_valid, keyless): two samples of windows of 1, 63, 64,
    65, 144 and 300 tokens and one of 20 whose keys are all invalid (in
    order, then reversed), 20 % of the other keys invalid, an INT32_MAX
    tail; keyless marks the 20-token window's rows."""
    rng = np.random.default_rng(12)
    win = np.full((2, V), INT_MAX, np.int32)
    kv = rng.random((2, V)) > 0.2
    keyless = np.zeros((2, V), bool)
    for b, sizes in enumerate((WINDOW_SIZES, WINDOW_SIZES[::-1])):
        r = 0
        for w, n in enumerate(sizes):
            win[b, r:r + n] = 3 * w
            keyless[b, r:r + n] = n == 20
            r += n
    kv &= (win != INT_MAX) & ~keyless
    return tuple(map(torch.from_numpy, (win, kv, keyless)))


def band_layout(which, dev):
    """(win_id, key_valid): one sample of windows up to 150 tokens, a batch
    of four, the pretrain encoder's layout at reduced batch, or windows of
    1 to 300 tokens and one without a valid key."""
    if which == "sizes":
        return sized_windows()[:2]
    if which == "encoder":
        lay = encoder_tokens(dev)
        return lay["win_id"], lay["key_valid_sorted"]
    rng = np.random.default_rng(11)
    return windows(rng, B=1 if which == "one" else 4, V=2048)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["one", "batch", "encoder", "sizes"])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_band_attention_fused(dev, dtype, which, heads):
    """K8 forward: output and statistics against the plain versions; the
    output without statistics is the same; padding rows are 0."""
    q, k, v, win, kv, _ = band_case(dtype, dev, *band_layout(which, dev),
                                    heads=heads)
    before = attention.band_attention_fused.launches
    out, lse = attention._forward(q, k, v, win, kv, stats=True)
    assert attention.band_attention_fused.launches == before + 1
    check(out, attention.band_attention(q, k, v, win, kv), *TOL[dtype])
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    check(lse, attention.band_attention_lse_plain(q, k, win, kv),
          *TOL[dtype])
    check(attention.band_attention_fused(q, k, v, win, kv), out, 0, 0)
    assert (out[win == INT_MAX] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["one", "batch", "encoder", "sizes"])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_band_attention_fused_backward(dev, dtype, which, heads):
    """K8 backward from the forward kernel's statistics against the plain
    backward (which recomputes its softmax), per row; one prologue and
    one backward launch; zero on padding rows (and dq on the rows of a
    window without a valid key); two launches bitwise equal (no
    atomics).  In bf16 the column sums of dk, an exact 0 (sum_j ds_ij =
    0 for every query i), within F3's key-bias bound
    (``probe_qkv.dbk_bound`` of the f32 dk), as K7's dbk is held."""
    q, k, v, win, kv, d = band_case(dtype, dev, *band_layout(which, dev),
                                    heads=heads)
    out, lse = attention._forward(q, k, v, win, kv, stats=True)
    f, p = attention.band_attention_fused_backward, \
        attention.band_attention_delta
    before = (f.launches, p.launches)
    got = f(q, k, v, win, kv, out, lse, d)
    assert (f.launches, p.launches) == (before[0] + 1, before[1] + 1)
    want = attention.band_attention_backward_plain(q, k, v, win, kv, out, d)
    flat = lambda ts: [t.flatten(2) for t in ts]
    check_grads(flat(got), flat(want), dtype, 3)
    for t in got:
        assert t.dtype == dtype and (t[win == INT_MAX] == 0).all()
    if which == "sizes":
        assert (got[0][sized_windows()[2].to(dev)] == 0).all()
    again = f(q, k, v, win, kv, out, lse, d)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.bfloat16:
        f32 = [t.float() for t in (q, k, v)]
        dk32 = attention.band_attention_backward_plain(
            *f32, win, kv, out.float(), d.float())[1]
        bound = probe_qkv.dbk_bound(dk32.flatten(2))
        dbk = got[1].float().flatten(2).sum((0, 1))
        assert (dbk.abs() <= bound).all(), float((dbk.abs() / bound).max())


@pytest.mark.parametrize("V", [768, 700])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_band_attention_fused_bf16_against_its_tiles(dev, V, heads):
    """The bf16 forward on the tensor cores against its plain twin
    (``band_attention_tiles_plain``: the kernel's tiles, chunks and online
    softmax), on windows of 1 to 300 tokens with one that has no valid
    key, V a multiple of the 64-token tile and not: the output per row at
    TOL; the statistics at 1e-4 + 1e-5 relative (f32 in log2 units with
    ex2.approx against natural exp); one launch a call; padding rows and
    the keyless window's rows 0 with lse 0; two launches bitwise equal
    (no atomics)."""
    win, kv, keyless = sized_windows(V)
    q, k, v, win, kv, _ = band_case(torch.bfloat16, dev, win, kv,
                                    heads=heads)
    before = attention.band_attention_fused.launches
    out, lse = attention._forward(q, k, v, win, kv, stats=True)
    assert attention.band_attention_fused.launches == before + 1
    want, want_lse = attention.band_attention_tiles_plain(q, k, v, win, kv)
    check_grads((out.flatten(2),), (want.flatten(2),), torch.bfloat16, 1)
    check(lse, want_lse, 1e-4, 1e-5)
    empty = (win == INT_MAX) | keyless.to(dev)
    assert (out[empty] == 0).all() and (lse[empty] == 0).all()
    again = attention._forward(q, k, v, win, kv, stats=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_band_attention_delta(dev, dtype, heads):
    """The backward's prologue against its plain twin: D products, exact
    in f32 from bf16 inputs (below D 8 both round each f32 product
    alike), added in another order (at most (D - 1) x 2^-24 x sum
    |terms|); 0 on padding rows."""
    q, k, v, win, kv, d = band_case(dtype, dev, *band_layout("batch", dev),
                                    heads=heads)
    out = attention.band_attention_fused(q, k, v, win, kv)
    before = attention.band_attention_delta.launches
    got = attention.band_attention_delta(out, d, win)
    assert attention.band_attention_delta.launches == before + 1
    want = attention.band_attention_delta_plain(out, d, win)
    assert got.dtype == torch.float32 and got.shape == want.shape
    mag = attention.band_attention_delta_plain(out.abs(), d.abs(), win)
    assert ((got - want).abs() <= (heads[1] - 1) * 2.0 ** -24 * mag).all()
    assert (got[win == INT_MAX] == 0).all()


def pow2_scale(D: int) -> float:
    """The power of two nearest 1/sqrt(D) in log2: 1/4 at D = 12 and 24,
    1/8 at 48 and 96, 1/16 at 192, 384 and 512, 1 at D = 2 and 1/2 at 3
    and 6, where the true scale is none."""
    return 2.0 ** round(float(np.log2(D ** -0.5)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", ODD_HEADS, ids=[f"{h}x{d}" for h, d in
                                                  ODD_HEADS])
def test_odd_head_widths_fail_a_power_of_two_scale(dev, dtype, heads):
    """A planted fault at the head widths that are not a power of two:
    K8's and K6's outputs, which meet their rule against the plain
    versions (``test_band_attention_fused``, ``test_band_attention_qkv_
    statistics``), fail it against the plain versions run with the scale
    a power of two (``pow2_scale``: 1/4 for 1/sqrt(12) = 0.289 and
    1/sqrt(24) = 0.204, 1/8 for 1/sqrt(48) = 0.144 and 1/sqrt(96) =
    0.102, 1/16 for 1/sqrt(192) = 0.072, 1/sqrt(384) = 0.051 and
    1/sqrt(512) = 0.044, 1 for 1/sqrt(2) = 0.707, 1/2 for 1/sqrt(3) =
    0.577 and 1/sqrt(6) = 0.408), so a kernel that took such a guess for
    1/sqrt(D) would not pass; at D 12 that guess is the scale of the
    16-channel slots the bf16 kernels run the head over, at D 2, 3 and 6
    the 8-channel slots' is 1/sqrt(8), no power of two either."""
    H, D = heads
    q, k, v, win, kv, _ = band_case(dtype, dev, *band_layout("batch", dev),
                                    heads=heads)
    got = attention.band_attention_fused(q, k, v, win, kv)
    check(got, attention.band_attention(q, k, v, win, kv), *TOL[dtype])
    with pytest.raises(AssertionError):
        check(got, attention.band_attention(q, k, v, win, kv,
                                            scale=pow2_scale(D)),
              *TOL[dtype])
    args, _ = attention_case(dtype, dev, C=H * D)
    got = attention_qkv.band_attention_qkv(*args, H)
    check(got, attention_qkv.band_attention_qkv_plain(*args, H), *TOL[dtype])
    x, pos, wq, bq, wk, bk, wv, bv, w_id, k_valid = args
    shape = (*x.shape[:2], H, D)
    pq, pk, pv = (t.reshape(shape) for t in attention_qkv.qkv_project_plain(
        x, pos, wq, bq, wk, bk, wv, bv, w_id))
    wrong = attention.band_attention(pq, pk, pv, w_id, k_valid,
                                     scale=pow2_scale(D)).flatten(2)
    with pytest.raises(AssertionError):
        check(got, wrong, *TOL[dtype])


def test_band_attention_fused_autograd_and_refusals(dev):
    """Under grad: one forward launch with statistics, one backward
    launch, gradients in the inputs' dtype; without grad no statistics.
    Other head shapes and dtypes are refused."""
    q, k, v, win, kv, d = band_case(torch.bfloat16, dev,
                                    *band_layout("one", dev))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    f, b = attention.band_attention_fused, \
        attention.band_attention_fused_backward
    counts = lambda: (f.launches, f.stats, b.launches)
    before = counts()
    f(q, k, v, win, kv).backward(d)
    assert [c - a for c, a in zip(counts(), before)] == [1, 1, 1]
    assert all(t.grad.dtype == torch.bfloat16
               and torch.isfinite(t.grad.float()).all() for t in (q, k, v))
    with torch.no_grad():
        before = counts()
        f(q, k, v, win, kv)
        assert [c - a for c, a in zip(counts(), before)] == [1, 0, 0]
    w64, kv64 = win[:, :64].contiguous(), kv[:, :64].contiguous()
    # C 32, C 768 in one head of 768, in 3 heads of 256 and in 128 of 6,
    # C 640 in 160 heads of 4, in one head and in 128 heads of 5, C 1024
    # in 256 heads of 4, C 1152 in 18 heads of 64
    for heads in ((4, 8), (1, 768), (160, 4), (3, 256), (128, 6), (1, 640),
                  (256, 4), (128, 5), (18, 64)):
        bad = torch.randn(1, 64, *heads, device=dev)
        with pytest.raises(ValueError):
            f(bad, bad, bad, w64, kv64)
    half = torch.randn(1, 64, 8, 16, device=dev).half()
    with pytest.raises(ValueError):       # float16
        f(half, half, half, w64, kv64)
