"""K6 band_attention_qkv: window attention with the q/k/v projections
inside; the CUDA wrappers of its forward (K6) and backward (K7), of the
bf16 projections they run on the tensor cores, and their plain versions.

Replaces ``geomae_tpu/ops/pallas_attention_qkv.py:band_attention_qkv``
(forward, and its backward ``_pallas_backward_merged`` /
``_pallas_backward_split``); the kernels are ``csrc/window_attention.cuh``
(a translation unit a C, ``window_attention_c*.cu``; the entry points
in ``window_attention.cu``).
Computes, over window-sorted tokens,

    q = (x + pos) Wq + bq,   k = (x + pos) Wk + bk,   v = x Wv + bv
    out = per head softmax(q k^T / sqrt(D) + mask) v

and returns the attention output BEFORE the out-projection (that one is
inside K5, ``ops/ffn.py``).  Weights are [C_in, C_out] as in the JAX
package, without its group axis.  ``pos`` is cast to x's dtype; the
projections accumulate in f32, cast to x's dtype, then add the bias in
that dtype (``pallas_attention_qkv._proj``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises.  The kernels take every width K8 takes (``KERNEL_CHANNELS``):
C of 128, 256, 384 or 512 in heads of 1, 2, 4, 8, 16, 32, 64 or 128, C
384 in heads of 3, 6, 12, 24, 48, 96 or 192, C 256 and 512 in heads of
256, C 384 and 512 in one head, and C 640, 768 and 1024 in heads of 8,
16, 32, 64 or 128 (``kernel_takes``), in float32 or bfloat16 (the bf16
projections own 128-, 64- or 32-column slices of the three products
with the weights they read resident, above C 512 a 64-row tile and a
64-column slice with the contraction streamed; the f32 kernels blocks
of 256 threads, C / 2 at C 384 and 512, C / 4 above, a lane several
whole heads below D 8); windows may be of any size.  The scale
1/sqrt(D) folds into q where D is a power of four (1, 4, 16, 64, 256),
as in the JAX package, and multiplies the f32 score elsewhere (2, 3, 6,
8, 12, 24, 32, 48, 96, 128, 192, 384, 512).  In bfloat16 each token is
projected once on the tensor cores (``qkv_project``) and K8's bf16
kernels (``csrc/band_attention.cuh``, reached through their C
entry points, so
``attention.band_attention_fused``'s counts stay the band route's) run
the attention; the backward recomputes the projections, runs K8's D
prologue and backward, then
``qkv_project_backward`` (dx and the parameter gradients).  K8 rounds its
probabilities against the running max of each 64-key chunk.  In float32
one CUDA-core kernel each way projects inside the attention.

Under grad the attention is an ``autograd.Function``: the forward also
writes each (row, head)'s log-sum-exp of the scores ([B, V, H] f32), and
the backward (``band_attention_qkv_backward``) returns dx, which sums the
query-side and key-side terms, and dWq, dbq, dWk, dbk, dWv, dbv in f32.
``pos`` gets no cotangent, as in the JAX package.  Without grad the
forward launches without the statistics, as in serving.
"""
from __future__ import annotations

import torch

from . import _cuda, attention
from .attention import (INT32_MAX, KERNEL_HEAD_DIMS, band_attention,
                        plain_blocks, plain_lse)
from .ffn import dense

# K6, K7 and the projections take K8's widths: C in KERNEL_CHANNELS (the
# projections see no heads) in heads of KERNEL_HEAD_DIMS, 3, 6, 12, 24,
# 48, 96 and 192 at C 384 alone, 256 at C 256 and 512, 384 and 512 in one
# head, and heads of 8 to 128 alone at C 640, 768 and 1024 (kernel_takes)
KERNEL_CHANNELS = attention.KERNEL_CHANNELS


def kernel_takes(channels: int, heads: int) -> bool:
    """Whether K6 and K7 take ``heads`` heads over ``channels``: every
    width K8 takes (``attention.kernel_takes``), the 15 widths of C 640,
    768 and 1024 among them."""
    return attention.kernel_takes(channels, heads)

# The bf16 weight-gradient kernel stages 128 columns of its rows a block
# (104 KB of shared memory at every C): two blocks an SM
WGRAD_BLOCKS_PER_SM = 2
WGRAD_TILE = 128          # its output tile, a side
# The f32 backward kernel's blocks hold a tile of f32_tile tokens (98 KB
# of shared memory, 74 KB at C 384), and their threads of up to 255
# registers leave no room for a second block: one block an SM.
# Each block owns an f32 partial of the weight gradients, [3 C C + 3 C],
# so the grid is also held to F32_PARTIAL_BYTES of them up to C 256 (85
# blocks at C = 256, every SM at 128).  At C 384, 512, 640, 768 and 1024
# a partial is 1.8, 3.1, 4.9, 7.1 and 12.6 MB, and 64 MiB would leave 37,
# 20, 13, 9 and 5 blocks for 132 SMs: F32_PARTIAL_BYTES_WIDE admits a
# block an SM there (233 MB to 1.66 GB on an H100, the scratch of one
# call)
F32_PARTIAL_BYTES = 64 << 20
F32_PARTIAL_BYTES_WIDE = 2 << 30


def f32_threads(C: int) -> int:
    """Threads a block of the f32 kernels at C channels: 256 up to C 256,
    C / 2 at 384 and 512, C / 4 at 640, 768 and 1024
    (``F32W::kThreads``)."""
    return 256 if C <= 256 else C // 2 if C <= 512 else C // 4


def _scale_pow2(head_dim: int) -> bool:
    """1/sqrt(head_dim) is a power of two (head_dim a power of four):
    folding the scale into q is then exact in any float dtype."""
    lb = head_dim.bit_length() - 1
    return head_dim == (1 << lb) and lb % 2 == 0


def qkv_project_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id):
    """The projections (q, k, v) [B, V, C] in x's dtype: x + pos rounded
    to it, then ``dense`` (f32 accumulation, the product rounded, the
    bias added in x's dtype); 0 on padding rows (``win_id ==
    INT32_MAX``), as the kernel writes them."""
    xp = x + pos.to(x.dtype)
    real = (win_id != INT32_MAX)[..., None]
    return tuple(torch.where(real, dense(a, w, b), 0.0)
                 for a, w, b in ((xp, wq, bq), (xp, wk, bk), (x, wv, bv)))


def qkv_project_backward_plain(x, pos, wq, wk, wv, dq, dk, dv):
    """The projections' backward for the cotangents dq, dk, dv [B, V, C]
    of q, k, v: (dx, dWq, dbq, dWk, dbk, dWv, dbv), dx = rt(rt(dq Wq^T) +
    rt(dk Wk^T + dv Wv^T)) in x's dtype (rt: rounded to it), the weight
    products (x+pos)^T dq, (x+pos)^T dk, x^T dv and the bias sums in f32,
    over every row (padding rows add their cotangents as given: K8's
    backward writes 0 there)."""
    dt = x.dtype
    C = x.shape[-1]
    rt = lambda t: t.to(dt).float()
    W = lambda w: w.to(dt).float()
    dq, dk, dv = dq.float(), dk.float(), dv.float()
    dx = rt(rt(dq @ W(wq).t()) + rt(dk @ W(wk).t() + dv @ W(wv).t()))
    flat = lambda t: t.float().reshape(-1, C)
    xp = x + pos.to(dt)
    grads = []
    for a, d in ((xp, dq), (xp, dk), (x, dv)):
        grads += [flat(a).t() @ flat(d), flat(d).sum(0)]
    return (dx.to(dt), *grads)


def band_attention_qkv_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                             key_valid, nheads: int) -> torch.Tensor:
    B, V, C = x.shape
    D = C // nheads
    q, k, v = qkv_project_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id)
    scale = D ** -0.5
    if _scale_pow2(D):
        q, scale = q * scale, 1.0
    shape = (B, V, nheads, D)
    out = band_attention(q.reshape(shape), k.reshape(shape),
                         v.reshape(shape), win_id, key_valid, scale)
    return out.reshape(B, V, C)


def _plain_qkv(x, pos, wq, bq, wk, bk, wv, bv, win_id, nheads: int):
    """(q, k, v, scale, fold): q, k, v f32 [B, V, H, D] as the kernels
    round them, q already scaled when ``fold``."""
    B, V, C = x.shape
    D = C // nheads
    dt = x.dtype
    q, k, v = (t.float() for t in qkv_project_plain(x, pos, wq, bq, wk, bk,
                                                    wv, bv, win_id))
    scale = D ** -0.5
    fold = _scale_pow2(D)
    if fold:
        q = (q * scale).to(dt).float()
    shape = (B, V, nheads, D)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape), scale, fold


def band_attention_qkv_lse_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                                 key_valid, nheads: int) -> torch.Tensor:
    """The forward kernel's statistics under grad: per (row, head) the
    log-sum-exp of the masked, scaled scores, [B, V, H] f32; 0 for a
    padding row or a row with no valid key."""
    q, k, _, scale, fold = _plain_qkv(x, pos, wq, bq, wk, bk, wv, bv,
                                      win_id, nheads)
    return plain_lse(q, k, win_id, key_valid, 1.0 if fold else scale)


def band_attention_qkv_backward_plain(x, pos, wq, bq, wk, bk, wv, bv,
                                      win_id, key_valid, nheads: int, out,
                                      g):
    """The backward kernel's function: (dx, dWq, dbq, dWk, dbk, dWv, dbv),
    dx in x's dtype, the rest f32.  ``out`` is the forward's output and
    ``g`` its cotangent: ``attention_grads_plain``, dq, dk and dv rounded
    to x's dtype, then ``qkv_project_backward_plain``."""
    dt = x.dtype
    dq, dk, dv = attention_grads_plain(x, pos, wq, bq, wk, bk, wv, bv,
                                       win_id, key_valid, nheads, out, g)
    return qkv_project_backward_plain(x, pos, wq, wk, wv, dq.to(dt),
                                      dk.to(dt), dv.to(dt))


def attention_grads_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id, key_valid,
                          nheads: int, out, g):
    """The f32 cotangents (dq, dk, dv) [B, V, C] of the projections q, k,
    v, before the backward rounds them to x's dtype.  The softmax is
    recomputed exactly per window (as ``band_attention`` does); ds and p
    are rounded to x's dtype before their products (``_bwd_merged_kernel``)."""
    B, V, C = x.shape
    dt = x.dtype
    rt = lambda t: t.to(dt).float()
    q, k, v, scale, fold = _plain_qkv(x, pos, wq, bq, wk, bk, wv, bv,
                                      win_id, nheads)
    shape = q.shape
    gh = g.float().reshape(shape)
    dvo = (gh * out.float().reshape(shape)).sum(-1)          # [B, V, H]
    dq, dk, dv = (torch.zeros(shape, device=x.device) for _ in range(3))
    for b, q0, q1, ks, ke, _, p in plain_blocks(
            q, k, win_id, key_valid, 1.0 if fold else scale):
        qb, kb, vb, gb = q[b, q0:q1], k[b, ks:ke], v[b, ks:ke], gh[b, q0:q1]
        dp = torch.einsum("qhd,khd->hqk", gb, vb)
        ds = rt(p * (dp - dvo[b, q0:q1].t()[..., None]))
        dq[b, q0:q1] += torch.einsum("hqk,khd->qhd", ds, kb)
        dk[b, ks:ke] += torch.einsum("hqk,qhd->khd", ds, qb)
        dv[b, ks:ke] += torch.einsum("hqk,qhd->khd", rt(p), gb)
    return (dq.reshape(B, V, C) * scale,
            dk.reshape(B, V, C) * (1.0 if fold else scale),
            dv.reshape(B, V, C))


def _check_qkv(name, x, nheads, dtypes=tuple(_cuda.DTYPE_CODE)):
    """x [B, V, C] on the card at a width the kernels take: C in
    KERNEL_CHANNELS in ``nheads`` heads of D in KERNEL_HEAD_DIMS, 3, 6,
    12, 24, 48, 96 and 192 at C 384 alone, 256 at C 256 and 512, 384 and
    512 in one head, 8 to 128 alone at C 640, 768 and 1024
    (``kernel_takes``; the projections see no heads: ``nheads`` None, C in
    KERNEL_CHANNELS)."""
    _cuda.require(x.device.type == "cuda",
                  f"{name}: no kernel for device {x.device}")
    kinds = " or ".join(str(d)[6:] for d in dtypes)
    C = x.shape[-1]
    takes = (C in KERNEL_CHANNELS if nheads is None
             else kernel_takes(C, nheads))
    _cuda.require(x.dim() == 3 and takes and x.dtype in dtypes,
                  f"{name}: the kernel takes [B, V, C] {kinds} with C in "
                  f"{KERNEL_CHANNELS} in heads of D in {KERNEL_HEAD_DIMS} "
                  f"(3, 6, 12, 24, 48, 96 and 192 at C 384 alone, 384 and "
                  f"512 in one head, 8 to 128 alone at C 640, 768 and "
                  f"1024), got {x.dtype} {tuple(x.shape)} in {nheads} "
                  f"heads")


def _kernel_inputs(name, x, pos, ws, win_id=None, key_valid=None):
    """pos and the weights ([C, C], and [C] after each when ``ws`` holds
    the biases too) in x's dtype, all checked and contiguous; in bf16
    also 16-byte aligned (the kernels copy rows 16 bytes at a time)."""
    B, V, C = x.shape
    pos = pos.to(x.dtype).contiguous()
    ws = [w.to(x.dtype).contiguous() for w in ws]
    ids = [t for t in (win_id, key_valid) if t is not None]
    _cuda.require_cuda(name, x, pos, *ids, *ws)
    _cuda.require(pos.shape == x.shape, f"{name}: pos {tuple(pos.shape)}")
    shapes = [(C, C), (C,)] * 3 if len(ws) == 6 else [(C, C)] * 3
    for w, shape in zip(ws, shapes):
        _cuda.require(w.shape == shape,
                      f"{name}: weight {tuple(w.shape)}, expected {shape}")
    _cuda.require(win_id is None or (win_id.dtype == torch.int32
                                     and win_id.shape == (B, V)),
                  f"{name}: win_id must be int32 {(B, V)}")
    _cuda.require(key_valid is None or (key_valid.dtype == torch.bool
                                        and key_valid.shape == (B, V)),
                  f"{name}: key_valid must be bool {(B, V)}")
    if x.dtype == torch.bfloat16:
        _aligned(name, x, pos, *ws)
    return pos, ws


def _aligned(name, *ts):
    for t in ts:
        _cuda.require(t.data_ptr() % 16 == 0,
                      f"{name}: tensors must be 16-byte aligned")


def _cotangents(name, x, *ts):
    """Each of ``ts`` of x's shape and dtype, on its device, contiguous
    and (bf16) 16-byte aligned."""
    for t in ts:
        _cuda.require(t.shape == x.shape and t.dtype == x.dtype,
                      f"{name}: cotangents and outputs must be {x.dtype} "
                      f"{tuple(x.shape)}, got {t.dtype} {tuple(t.shape)}")
    _cuda.require_cuda(name, x, *ts)
    if x.dtype == torch.bfloat16:
        _aligned(name, *ts)


def _grads(grads, C):
    """The kernels' f32 [3 C C + 3 C] as (dWq, dbq, dWk, dbk, dWv, dbv)."""
    dwq, dwk, dwv, dbq, dbk, dbv = grads.split([C * C] * 3 + [C] * 3)
    return dwq.view(C, C), dbq, dwk.view(C, C), dbk, dwv.view(C, C), dbv


def _project(x, pos, ws, win_id):
    """The bf16 projections' kernel on checked inputs: (q, k, v)."""
    B, V, _ = x.shape
    q, k, v = (torch.empty_like(x) for _ in range(3))
    code = _cuda.library().geomae_qkv_project(
        x.data_ptr(), pos.data_ptr(), *[w.data_ptr() for w in ws],
        win_id.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), B, V,
        x.shape[2], _cuda.stream(x))
    qkv_project.launches += 1
    _cuda.check(code, "qkv_project")
    return q, k, v


def wgrad_chunk_rows(x) -> int:
    """Rows a chunk of the bf16 weight gradients: a multiple of 64 that
    gives about one block (a chunk, one of the three products and one of
    its (C / 128)^2 output tiles) for each place on the device's SMs, so
    the grid fills the card once and the chunks' f32 partials stay about
    the card's size in blocks (``probe_qkv``: fewer, longer chunks leave
    SMs idle, more add partial sums to write and add)."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = 3 * (x.shape[-1] // WGRAD_TILE) ** 2     # a chunk's
    chunks = max(1, sms * WGRAD_BLOCKS_PER_SM // blocks)
    return 64 * max(1, -(-x.shape[0] * x.shape[1] // (64 * chunks)))


def f32_lane_channels(head_dim: int) -> int:
    """Channels of a head one lane of the f32 kernels keeps: 16, all of D
    = 8, 12 at D = 12, 24, 48, 96 and 192 (so a head's lanes are a power
    of two, 16 at D 192 and 256), the whole head below 8
    (``common.cuh: f32_lane_channels``)."""
    if head_dim < 8:
        return head_dim
    return 12 if head_dim % 3 == 0 else min(head_dim, 16)


def f32_lane_heads(head_dim: int) -> int:
    """Heads one lane of K6 / K7's f32 kernels keeps: one from D 8 up,
    below it the heads of 8 channels (D 1, 2, 4) or 12 (D 3, 6)
    (``common.cuh: f32_lane_heads``)."""
    return (12 if head_dim % 3 == 0 else 8) // head_dim if head_dim < 8 \
        else 1


def f32_tile(C: int, nheads: int) -> int:
    """Tokens a tile of the f32 kernels at C in ``nheads`` heads: a block
    of ``f32_threads`` lanes, ``f32_lane_heads`` x ``f32_lane_channels``
    each: 4096 / C tokens up to C 256, 8 at C 384 and 512, 4 at C 640 to
    1024, half that at D = 8 (and 1, 2, 4), 6 at D = 12, 24, 48, 96 and
    192 (and 3, 6)."""
    D = C // nheads
    return f32_threads(C) * f32_lane_heads(D) * f32_lane_channels(D) // C


def bwd_blocks(x, nheads: int) -> int:
    """The f32 backward kernel's persistent grid on ``x`` [B, V, C] in
    ``nheads`` heads: one block an SM, at most one a tile (``f32_tile``),
    and no more than F32_PARTIAL_BYTES (F32_PARTIAL_BYTES_WIDE above C
    256) of partials hold."""
    B, V, C = x.shape
    tiles = B * -(-V // f32_tile(C, nheads))
    cap = F32_PARTIAL_BYTES if C <= 256 else F32_PARTIAL_BYTES_WIDE
    return max(1, min(_cuda.persistent_blocks(x, 1, tiles),
                      cap // (4 * (3 * C * C + 3 * C))))


def _project_backward(x, pos, weights, dq, dk, dv):
    """The bf16 projections' backward kernels on checked inputs: (dx, dWq,
    dbq, dWk, dbk, dWv, dbv)."""
    B, V, C = x.shape
    chunk_rows = wgrad_chunk_rows(x)
    chunks = -(-B * V // chunk_rows)
    n = 3 * C * C + 3 * C
    partial = torch.empty((chunks, n), dtype=torch.float32, device=x.device)
    grads = torch.empty(n, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    code = _cuda.library().geomae_qkv_project_bwd(
        x.data_ptr(), pos.data_ptr(), *[w.data_ptr() for w in weights],
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), grads.data_ptr(), B, V, C, chunk_rows, chunks,
        _cuda.stream(x))
    qkv_project_backward.launches += 1
    _cuda.check(code, "qkv_project_backward")
    return (dx, *_grads(grads, C))


def qkv_project(x, pos, wq, bq, wk, bk, wv, bv, win_id):
    """The projections of K6's bf16 path: (q, k, v) [B, V, C] in x's
    dtype, 0 on padding rows; on the card bf16 only, C in
    KERNEL_CHANNELS, on the tensor cores (each token once)."""
    if x.device.type == "cpu":
        return qkv_project_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id)
    name = "qkv_project"
    _check_qkv(name, x, None, (torch.bfloat16,))
    pos, ws = _kernel_inputs(name, x, pos, (wq, bq, wk, bk, wv, bv), win_id)
    return _project(x, pos, ws, win_id)


qkv_project.launches = 0


def qkv_project_backward(x, pos, wq, wk, wv, dq, dk, dv):
    """The projections' backward (``qkv_project_backward_plain``): dx in
    x's dtype, the six parameter gradients in f32; on the card bf16
    only, C in KERNEL_CHANNELS: dx on the tensor cores a tile of rows at
    a time, the weight gradients split over chunks of rows
    (``wgrad_chunk_rows``) whose f32 partials are summed in order (two
    calls agree bitwise)."""
    if x.device.type == "cpu":
        return qkv_project_backward_plain(x, pos, wq, wk, wv, dq, dk, dv)
    name = "qkv_project_backward"
    _check_qkv(name, x, None, (torch.bfloat16,))
    pos, ws = _kernel_inputs(name, x, pos, (wq, wk, wv))
    _cotangents(name, x, dq, dk, dv)
    return _project_backward(x, pos, ws, dq, dk, dv)


qkv_project_backward.launches = 0


def _forward(x, pos, wq, bq, wk, bk, wv, bv, win_id, key_valid, nheads,
             stats: bool):
    """(out, lse): lse [B, V, H] f32 when ``stats`` on a CUDA tensor, else
    None (the plain backward recomputes its softmax).  bf16: the
    projections, then K8's forward; f32: the CUDA-core kernel."""
    if x.device.type == "cpu":
        return band_attention_qkv_plain(x, pos, wq, bq, wk, bk, wv, bv,
                                        win_id, key_valid, nheads), None
    name = "band_attention_qkv"
    _check_qkv(name, x, nheads)
    pos, ws = _kernel_inputs(name, x, pos, (wq, bq, wk, bk, wv, bv), win_id,
                             key_valid)
    B, V, C = x.shape
    out = torch.empty_like(x)
    lse = (torch.empty((B, V, nheads), dtype=torch.float32, device=x.device)
           if stats else None)
    lib, dtype = _cuda.library(), _cuda.DTYPE_CODE[x.dtype]
    lse_ptr = None if lse is None else lse.data_ptr()
    if x.dtype == torch.bfloat16:
        q, k, v = _project(x, pos, ws, win_id)
        code = lib.geomae_band_attention(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            win_id.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
            lse_ptr, B, V, nheads, C // nheads, _cuda.stream(x))
    else:
        code = lib.geomae_band_attention_qkv(
            dtype, x.data_ptr(), pos.data_ptr(), *[w.data_ptr() for w in ws],
            win_id.data_ptr(), key_valid.data_ptr(), out.data_ptr(), lse_ptr,
            B, V, C, nheads, _cuda.stream(x))
    band_attention_qkv.launches += 1
    band_attention_qkv.stats += lse is not None
    _cuda.check(code, name)
    return out, lse


def band_attention_qkv_backward(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                                key_valid, nheads: int, out, lse, g):
    """K7: (dx, dWq, dbq, dWk, dbk, dWv, dbv) for the cotangent ``g`` of
    ``out``; dx in x's dtype, the rest f32.  ``lse`` is the forward
    kernel's statistics (unused by the plain version).  bf16: the
    projections again, K8's D prologue and backward (dq, dk, dv; 0 on
    padding rows), then the projections' backward; f32: the CUDA-core
    kernel."""
    if x.device.type == "cpu":
        return band_attention_qkv_backward_plain(
            x, pos, wq, bq, wk, bk, wv, bv, win_id, key_valid, nheads, out, g)
    name = "band_attention_qkv_backward"
    _check_qkv(name, x, nheads)
    pos, ws = _kernel_inputs(name, x, pos, (wq, bq, wk, bk, wv, bv), win_id,
                             key_valid)
    B, V, C = x.shape
    _cuda.require(lse is not None and lse.dtype == torch.float32
                  and lse.shape == (B, V, nheads),
                  f"{name}: lse must be the forward's f32 {(B, V, nheads)}")
    _cotangents(name, x, out, g)
    _cuda.require_cuda(name, x, lse)
    lib, dtype, stream = _cuda.library(), _cuda.DTYPE_CODE[x.dtype], \
        _cuda.stream(x)
    if x.dtype == torch.bfloat16:
        q, k, v = _project(x, pos, ws, win_id)
        delta = torch.empty((B, V, nheads), dtype=torch.float32,
                            device=x.device)
        _cuda.check(lib.geomae_band_attention_delta(
            dtype, g.data_ptr(), out.data_ptr(), win_id.data_ptr(),
            delta.data_ptr(), B, V, nheads, C // nheads, stream), name)
        dq, dk, dv = (torch.empty_like(x) for _ in range(3))
        code = lib.geomae_band_attention_bwd(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            win_id.data_ptr(), key_valid.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, V, nheads, C // nheads, stream)
        band_attention_qkv_backward.launches += 1
        _cuda.check(code, name)
        return _project_backward(x, pos, ws[0::2], dq, dk, dv)
    wT = [w.t().contiguous() for w in ws[0::2]]
    blocks = bwd_blocks(x, nheads)
    n = 3 * C * C + 3 * C
    partial = torch.zeros((blocks, n), dtype=torch.float32, device=x.device)
    grads = torch.empty(n, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    code = lib.geomae_band_attention_qkv_bwd(
        dtype, x.data_ptr(), pos.data_ptr(),
        *[w.data_ptr() for w in ws], *[w.data_ptr() for w in wT],
        win_id.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), B, V, C, nheads, blocks, stream)
    band_attention_qkv_backward.launches += 1
    _cuda.check(code, name)
    return (dx, *_grads(grads, C))


band_attention_qkv_backward.launches = 0


class _BandAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, wq, bq, wk, bk, wv, bv, win_id, key_valid,
                nheads):
        out, lse = _forward(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                            key_valid, nheads, stats=True)
        ctx.save_for_backward(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                              key_valid, out, lse)
        ctx.nheads = nheads
        return out

    @staticmethod
    def backward(ctx, g):
        (x, pos, *ws, win_id, key_valid, out, lse) = ctx.saved_tensors
        dx, *grads = band_attention_qkv_backward(
            x, pos, *ws, win_id, key_valid, ctx.nheads, out, lse,
            g.contiguous())
        grads = [d.to(w.dtype) for d, w in zip(grads, ws)]
        return (dx, None, *grads, None, None, None)


def band_attention_qkv(x: torch.Tensor, pos: torch.Tensor, wq, bq, wk, bk,
                       wv, bv, win_id: torch.Tensor, key_valid: torch.Tensor,
                       nheads: int) -> torch.Tensor:
    """x, pos [B, V, C]; W* [C, C]; b* [C]; win_id int32 [B, V] (window-
    sorted, INT32_MAX padding last); key_valid bool [B, V].  Returns the
    pre-out-projection attention output [B, V, C] in x's dtype."""
    args = (x, pos, wq, bq, wk, bk, wv, bv, win_id, key_valid)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _BandAttentionQKV.apply(*args, nheads)
    return _forward(*args, nheads, stats=False)[0]


band_attention_qkv.launches = 0
band_attention_qkv.stats = 0      # launches that wrote the statistics
