"""Windowed attention over window-sorted, already projected q, k, v: the
plain PyTorch versions and the CUDA wrappers of K8, forward and backward.

``band_attention`` is the port of ``geomae_tpu/ops/attention.py:
band_attention`` (the JAX einsum route) and the plain version of K8's
forward; ``band_attention_fused`` replaces ``geomae_tpu/ops/
pallas_attention.py:band_attention_pallas`` and its backward
``_pallas_backward`` (the kernels are ``csrc/band_attention.cuh``, a
translation unit a row width, ``csrc/band_attention_c*.cu``).  Tokens
are sorted by window id (``ops/windows.py``), so each window is a
contiguous run and attention is exact per window.  The JAX functions reach
the keys through a fixed band of neighbouring tiles; here each chunk of
queries takes the exact key range that covers its windows (two sorted
searches), which holds windows of any size.

Dtype points follow the TPU kernel (``pallas_attention._fwd_body``,
``_dq_body``, ``_dkv_body``): scores and the softmax sum in f32, the
1/sqrt(D) scale on the f32 score, the probabilities cast to v's dtype for
the value product, f32 accumulation; in the backward D = rowsum(dO * out)
in f32, ds and p cast to the compute dtype before their products, dq and
dk scaled after the f32 sum.  Padding rows (``win_id == INT32_MAX``) and
rows with no visible key return 0 and get zero gradients.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  The kernels take heads of D in ``KERNEL_HEAD_DIMS`` (1, 2, 3,
4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512) that make C
= H D one of ``KERNEL_CHANNELS`` (128, 256, 384, 512, 640, 768, 1024; D
3, 6, 12, 24, 48, 96 and 192 only at C 384, in 128, 64, 32, 16, 8, 4 and
2 heads; D 256 at C 256 and 512, in 1 and 2; D 384 and 512 at C 384 and
512, in one head; D 1, 2 and 4 at C 128 to 512, in 32 to 512 heads; at C
640, 768 and 1024 heads of ``WIDE_HEAD_DIMS``, 8 to 128, in 5 to 128
heads), in float32 or bfloat16; the plain versions take any H and D.
Below D 8 the bf16 kernels run D 8's over heads staged into 8-channel
slots whose channels past D are zero, and the f32 kernels give a lane
whole heads.  The bf16 forward runs on
the tensor cores over 64-token tiles with an online softmax per 64-key
chunk (``band_attention_tiles_plain`` is its order in plain PyTorch; at
D 384 and 512 two blocks share a head's output columns, each with the
same scores), the f32 forward on the CUDA cores; every kernel stages
whole heads of a fixed number of channels a block, so the order per head
is the same at every width.  Under grad ``band_attention_fused`` is an ``autograd.Function``: the
forward kernel also writes each (row, head)'s log-sum-exp of the scaled
scores ([B, V, H] f32, where the TPU kernel keeps the running max m and
the sum l apart; lse = m + log l).  The backward runs a prologue kernel
that computes D once for every real row (``band_attention_delta``), then
one kernel that returns dq, dk and dv, each key's dk and dv rounded once (the
TPU rounds per query tile): bf16 on the tensor cores over 64-token tiles
and 64-row chunks, 16-row chunks above D 128 (``backward_chunk``; at D
384 and 512 the tile as queries and the tile as keys are blocks of their
own, JAX's two passes in one launch; ``band_attention_backward_tiles_
plain`` is its decomposition in plain PyTorch), f32 on the CUDA cores.
"""
from __future__ import annotations

import functools

import torch

from . import _cuda

INT32_MAX = 2 ** 31 - 1
# C = H D the kernels take
KERNEL_CHANNELS = (128, 256, 384, 512, 640, 768, 1024)
# and D: 3, 6, 12, 24, 48, 96 and 192 at C 384 alone, 256 at C 256 and
# 512, 384 and 512 in one head; at the C above 512 (WIDE_CHANNELS) the
# heads of WIDE_HEAD_DIMS alone
KERNEL_HEAD_DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                    256, 384, 512)
WIDE_CHANNELS = (640, 768, 1024)
WIDE_HEAD_DIMS = (8, 16, 32, 64, 128)
PLAIN_Q_CHUNK = 1024      # queries per score block of the plain versions
KERNEL_TILE = 64          # tokens a tile (and rows a chunk) of the bf16
                          # kernels
WIDE_CHUNK = 16           # rows a chunk of the bf16 backward above D 128
NO_KEY = -2 ** 31         # a window id no window has: a row without a key


def band_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   win_id: torch.Tensor, key_valid: torch.Tensor | None = None,
                   scale: float | None = None,
                   q_chunk: int = PLAIN_Q_CHUNK) -> torch.Tensor:
    """q, k, v: [B, V, H, D] in window-sorted order; win_id int32 [B, V]
    ascending per row with INT32_MAX padding last; key_valid bool [B, V].
    ``scale`` defaults to 1/sqrt(D).  Returns [B, V, H, D] in v's dtype."""
    B, V, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.zeros_like(v)
    n_real = (win_id != INT32_MAX).sum(1).tolist()
    for b in range(B):
        w = win_id[b]
        kv = (torch.ones_like(w, dtype=torch.bool) if key_valid is None
              else key_valid[b])
        for q0 in range(0, n_real[b], q_chunk):
            q1 = min(q0 + q_chunk, n_real[b])
            ks = int(torch.searchsorted(w, w[q0:q0 + 1]))
            ke = int(torch.searchsorted(w, w[q1 - 1:q1], right=True))
            s = torch.einsum("qhd,khd->hqk", q[b, q0:q1].float(),
                             k[b, ks:ke].float()) * scale
            mask = (w[q0:q1, None] == w[None, ks:ke]) & kv[None, ks:ke]
            nonempty = mask.any(-1)
            s = s.masked_fill(~mask, float("-inf"))
            m = torch.where(nonempty[None, :, None],
                            s.amax(-1, keepdim=True), 0.0)
            p = torch.exp(s - m)
            lsum = p.sum(-1).clamp_min(1e-20)                  # [H, q]
            o = torch.einsum("hqk,khd->qhd", p.to(v.dtype).float(),
                             v[b, ks:ke].float())
            o = o / lsum.t()[..., None]
            out[b, q0:q1] = torch.where(nonempty[:, None, None], o,
                                        0.0).to(v.dtype)
    return out


def band_attention_tiles_plain(q, k, v, win_id, key_valid,
                              tile: int = KERNEL_TILE,
                              chunk: int = KERNEL_TILE):
    """The bf16 forward kernel's order in plain PyTorch: (out [B, V, H, D]
    in v's dtype, lse [B, V, H] f32), the function of ``band_attention``
    and ``band_attention_lse_plain``.  Each ``tile`` of query rows takes
    the exact key range of its real rows' windows and walks it in
    ``chunk`` keys with an online softmax: per chunk the row's running max
    m moves to the chunk's masked max, O and the sum l rescale by exp(m_old
    - m), p = exp(s - m) is rounded to v's dtype before the value product
    and l adds the unrounded p; out = O (1 / l), lse = m + log l, both 0
    where a row sees no key.  A pair counts where the two window ids match
    and the key is valid; padding rows never match."""
    B, V, H, D = q.shape
    rt = lambda t: t.to(v.dtype).float()
    scale = D ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(qf.shape, device=q.device)
    lse = torch.zeros((B, V, H), device=q.device)
    for b in range(B):
        w = win_id[b]
        kw = torch.where(key_valid[b], w, NO_KEY)        # window as key
        n_real = int((w != INT32_MAX).sum())
        for t0 in range(0, n_real, tile):
            r = slice(t0, min(t0 + tile, V))
            last = min(t0 + tile, n_real) - 1
            ks = int(torch.searchsorted(w, w[t0:t0 + 1]))
            ke = int(torch.searchsorted(w, w[last:last + 1], right=True))
            n = r.stop - r.start
            m = torch.full((H, n), float("-inf"), device=q.device)
            lsum = torch.zeros((H, n), device=q.device)
            o = torch.zeros((H, n, D), device=q.device)
            for k0 in range(ks, ke, chunk):
                c = slice(k0, min(k0 + chunk, ke))
                s = torch.einsum("ihd,jhd->hij", qf[b, r], kf[b, c]) * scale
                s = s.masked_fill(~(w[r, None] == kw[None, c]),
                                  float("-inf"))
                mn = torch.maximum(m, s.amax(-1))
                base = torch.where(mn == float("-inf"), 0.0, mn)
                corr = torch.exp(m - base)
                p = torch.exp(s - base[..., None])
                lsum = lsum * corr + p.sum(-1)
                o = o * corr[..., None] + torch.einsum(
                    "hij,jhd->hid", rt(p), vf[b, c])
                m = mn
            seen = lsum > 0
            inv = torch.where(seen, 1.0 / lsum, 0.0)
            out[b, r] = (o * inv[..., None]).transpose(0, 1)
            lse[b, r] = torch.where(seen, m + torch.log(
                torch.where(seen, lsum, 1.0)), 0.0).t()
    return out.to(v.dtype), lse


def plain_blocks(q, k, win_id, key_valid, scale: float):
    """Over each sample's real queries in chunks of PLAIN_Q_CHUNK, for f32
    q, k [B, V, H, D]: (b, q0, q1, ks, ke, lse, p): the chunk's exact key
    range [ks, ke), per (head, query) the log-sum-exp of the masked scores
    ``scale`` x q k^T [H, q, 1] (-inf without a valid key) and the softmax
    [H, q, k] (0 where masked)."""
    n_real = (win_id != INT32_MAX).sum(1).tolist()
    for b in range(q.shape[0]):
        w, kv = win_id[b], key_valid[b]
        for q0 in range(0, n_real[b], PLAIN_Q_CHUNK):
            q1 = min(q0 + PLAIN_Q_CHUNK, n_real[b])
            ks = int(torch.searchsorted(w, w[q0:q0 + 1]))
            ke = int(torch.searchsorted(w, w[q1 - 1:q1], right=True))
            s = torch.einsum("qhd,khd->hqk", q[b, q0:q1],
                             k[b, ks:ke]) * scale
            mask = ((w[q0:q1, None] == w[None, ks:ke])
                    & kv[None, ks:ke])[None]
            s = s.masked_fill(~mask, float("-inf"))
            lse = torch.logsumexp(s, -1, keepdim=True)
            p = torch.where(mask, torch.exp(s - torch.where(
                torch.isfinite(lse), lse, 0.0)), 0.0)
            yield b, q0, q1, ks, ke, lse, p


def plain_lse(q, k, win_id, key_valid, scale: float) -> torch.Tensor:
    """Per (row, head) the log-sum-exp of the masked scores ``scale`` x
    q k^T of f32 q, k [B, V, H, D]: [B, V, H] f32, 0 for a padding row or
    a row with no valid key."""
    out = torch.zeros(q.shape[:3], device=q.device)
    for b, q0, q1, _, _, lse, _ in plain_blocks(q, k, win_id, key_valid,
                                                scale):
        out[b, q0:q1] = torch.where(torch.isfinite(lse), lse, 0.0)[..., 0].t()
    return out


def band_attention_lse_plain(q, k, win_id, key_valid) -> torch.Tensor:
    """The forward kernel's statistics under grad: lse [B, V, H] f32."""
    return plain_lse(q.float(), k.float(), win_id, key_valid,
                     q.shape[-1] ** -0.5)


def band_attention_delta_plain(out, g, win_id) -> torch.Tensor:
    """The backward's prologue: D = rowsum(g * out) per (row, head) in
    f32, [B, V, H] for out, g [B, V, H, D] (a bf16 product is exact in
    f32); 0 on padding rows (``win_id == INT32_MAX``).  Below D 8 the
    products are added in d order, as the kernel adds them."""
    p = g.float() * out.float()
    d = p.sum(-1) if p.shape[-1] >= 8 else functools.reduce(
        torch.add, p.unbind(-1))
    return torch.where((win_id != INT32_MAX)[..., None], d, 0.0)


def band_attention_backward_plain(q, k, v, win_id, key_valid, out, g):
    """The backward kernel's function, written from its formulas: (dq, dk,
    dv) [B, V, H, D] in the inputs' dtype for the cotangent ``g`` of the
    forward's ``out``.  With p the per-window softmax (recomputed exactly)
    and D = rowsum(g * out) per (row, head) in f32:
    dv = p^T g, ds = p (g v^T - D), dq = scale ds k, dk = scale ds^T q;
    p and ds are rounded to the inputs' dtype before their products, dq,
    dk and dv once at the end."""
    dt = q.dtype
    rt = lambda t: t.to(dt).float()
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    dvo = band_attention_delta_plain(out, g, win_id)        # [B, V, H]
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for b, q0, q1, ks, ke, _, p in plain_blocks(qf, kf, win_id, key_valid,
                                                scale):
        gb = gf[b, q0:q1]
        dp = torch.einsum("qhd,khd->hqk", gb, vf[b, ks:ke])
        ds = rt(p * (dp - dvo[b, q0:q1].t()[..., None]))
        dq[b, q0:q1] += torch.einsum("hqk,khd->qhd", ds, kf[b, ks:ke])
        dk[b, ks:ke] += torch.einsum("hqk,qhd->khd", ds, qf[b, q0:q1])
        dv[b, ks:ke] += torch.einsum("hqk,qhd->khd", rt(p), gb)
    return (dq * scale).to(dt), (dk * scale).to(dt), dv.to(dt)


def backward_chunk(head_dim: int) -> int:
    """Rows a chunk of the bf16 backward kernel at heads of ``head_dim``:
    64, 16 above 128 (``BwdTc::kRows``: two chunks of 64 rows of a
    256-channel head beside its 64-token tile would stage 405 KB; and
    ``BwdWide::kRows`` at 384 and 512, whose passes each stage two
    arrays of the tile and of two chunks)."""
    return KERNEL_TILE if head_dim <= 128 else WIDE_CHUNK


def band_attention_backward_tiles_plain(q, k, v, win_id, key_valid, out,
                                        lse, g, tile: int = KERNEL_TILE,
                                        chunk: int | None = None):
    """The bf16 backward kernel's decomposition in plain PyTorch: the same
    function as ``band_attention_backward_plain``, from the forward's
    ``lse`` [B, V, H] and D from ``band_attention_delta_plain``.  Each
    ``tile`` of tokens takes the exact key range of its real tokens'
    windows and walks it in ``chunk`` rows (by default the kernel's,
    ``backward_chunk``), once with the tile as queries
    (dq) and once as keys (dk, dv, gathered: complete when the range
    ends); a pair counts where the two window ids match and the key is
    valid, padding rows never match.  Dtype points as the plain backward's.
    """
    dt = q.dtype
    rt = lambda t: t.to(dt).float()
    B, V, H, D = q.shape
    chunk = chunk or backward_chunk(D)
    scale = D ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    dd = band_attention_delta_plain(out, g, win_id)
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for b in range(B):
        w = win_id[b]
        real = w != INT32_MAX
        kw = torch.where(real & key_valid[b], w, NO_KEY)   # window as key
        n_real = int(real.sum())
        for t0 in range(0, n_real, tile):
            r = slice(t0, min(t0 + tile, V))
            last = min(t0 + tile, n_real) - 1
            ks = int(torch.searchsorted(w, w[t0:t0 + 1]))
            ke = int(torch.searchsorted(w, w[last:last + 1], right=True))
            for k0 in range(ks, ke, chunk):
                c = slice(k0, min(k0 + chunk, ke))
                # the tile as queries, the chunk as keys
                s = torch.einsum("ihd,jhd->hij", qf[b, r], kf[b, c]) * scale
                p = torch.where(w[r, None] == kw[None, c], torch.exp(
                    s - lse[b, r].t()[..., None]), 0.0)
                dp = torch.einsum("ihd,jhd->hij", gf[b, r], vf[b, c])
                ds = rt(p * (dp - dd[b, r].t()[..., None]))
                dq[b, r] += torch.einsum("hij,jhd->ihd", ds, kf[b, c])
                # the tile as keys, the chunk as queries
                s = torch.einsum("ihd,jhd->hij", kf[b, r], qf[b, c]) * scale
                p = torch.where(kw[r, None] == w[None, c], torch.exp(
                    s - lse[b, c].t()[:, None]), 0.0)
                dp = torch.einsum("ihd,jhd->hij", vf[b, r], gf[b, c])
                ds = rt(p * (dp - dd[b, c].t()[:, None]))
                dv[b, r] += torch.einsum("hij,jhd->ihd", rt(p), gf[b, c])
                dk[b, r] += torch.einsum("hij,jhd->ihd", ds, qf[b, c])
    return (dq * scale).to(dt), (dk * scale).to(dt), dv.to(dt)


def kernel_takes(channels: int, heads: int) -> bool:
    """Whether the kernels take ``heads`` heads over ``channels``: C in
    KERNEL_CHANNELS and D = C / H in KERNEL_HEAD_DIMS (of which only C 384
    splits into heads of 3, 6, 12, 24, 48, 96 or 192, only 256 and 512
    into heads of 256, and heads of 384 and 512 are C 384 and 512 in one
    head), in WIDE_HEAD_DIMS (8 to 128) at C 640, 768 and 1024."""
    if not (heads > 0 and channels % heads == 0
            and channels in KERNEL_CHANNELS):
        return False
    dims = WIDE_HEAD_DIMS if channels in WIDE_CHANNELS else KERNEL_HEAD_DIMS
    return channels // heads in dims


def kernel_widths() -> list:
    """(C, D) of every width the kernels take, by C, then D: C in
    KERNEL_CHANNELS in heads of each D in KERNEL_HEAD_DIMS that divides
    it (C 128 // 48 heads would be D 64 again)."""
    return [(C, D) for C in KERNEL_CHANNELS for D in KERNEL_HEAD_DIMS
            if C % D == 0 and kernel_takes(C, C // D)]


def _check_rows(name, q, *more):
    """q and ``more`` [B, V, H, D] (``kernel_takes``) of one float dtype,
    on one CUDA device, contiguous and 16-byte aligned."""
    _cuda.require(q.device.type == "cuda",
                  f"{name}: no kernel for device {q.device}")
    _cuda.require(q.dim() == 4
                  and kernel_takes(q.shape[2] * q.shape[3], q.shape[2])
                  and q.dtype in _cuda.DTYPE_CODE,
                  f"{name}: the kernel takes [B, V, H, D] with D in "
                  f"{KERNEL_HEAD_DIMS} and H D in {KERNEL_CHANNELS} (D 3, "
                  f"6, 12, 24, 48, 96 and 192 at H D = 384 alone, D 384 "
                  f"and 512 in one head, D in {WIDE_HEAD_DIMS} alone at "
                  f"H D in {WIDE_CHANNELS}), float32 or bfloat16, "
                  f"got {q.dtype} {tuple(q.shape)}")
    for t in more:
        _cuda.require(t.shape == q.shape and t.dtype == q.dtype,
                      f"{name}: q, k, v and the cotangents must share "
                      f"{q.dtype} {tuple(q.shape)}, got {t.dtype} "
                      f"{tuple(t.shape)}")
    _cuda.require_cuda(name, q, *more)
    for t in (q, *more):
        _cuda.require(t.data_ptr() % 16 == 0,
                      f"{name}: tensors must be 16-byte aligned")


def _check(name, q, k, v, win_id, key_valid, *more):
    """What the kernels take; returns (B, V)."""
    _check_rows(name, q, k, v, *more)
    B, V = q.shape[:2]
    _cuda.require(win_id.dtype == torch.int32 and win_id.shape == (B, V),
                  f"{name}: win_id must be int32 {(B, V)}")
    _cuda.require(key_valid.dtype == torch.bool
                  and key_valid.shape == (B, V),
                  f"{name}: key_valid must be bool {(B, V)}")
    _cuda.require_cuda(name, q, win_id, key_valid)
    return B, V


def _forward(q, k, v, win_id, key_valid, stats: bool):
    """(out, lse): lse [B, V, H] f32 when ``stats`` on a CUDA tensor, else
    None (the plain backward recomputes its softmax)."""
    if q.device.type == "cpu":
        return band_attention(q, k, v, win_id, key_valid), None
    name = "band_attention_fused"
    B, V = _check(name, q, k, v, win_id, key_valid)
    H, D = q.shape[2:]
    out = torch.empty_like(v)
    lse = (torch.empty((B, V, H), dtype=torch.float32, device=q.device)
           if stats else None)
    code = _cuda.library().geomae_band_attention(
        _cuda.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        win_id.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, V, H, D, _cuda.stream(q))
    band_attention_fused.launches += 1
    band_attention_fused.stats += lse is not None
    _cuda.check(code, name)
    return out, lse


def band_attention_delta(out, g, win_id):
    """The backward's prologue kernel: D = rowsum(g * out) per (row, head),
    f32 [B, V, H], computed once for every real row; 0 on padding rows,
    which it does not read."""
    if out.device.type == "cpu":
        return band_attention_delta_plain(out, g, win_id)
    name = "band_attention_delta"
    _check_rows(name, out, g)
    B, V, H, D = out.shape
    _cuda.require(win_id.dtype == torch.int32 and win_id.shape == (B, V),
                  f"{name}: win_id must be int32 {(B, V)}")
    _cuda.require_cuda(name, out, win_id)
    delta = torch.empty((B, V, H), dtype=torch.float32, device=out.device)
    code = _cuda.library().geomae_band_attention_delta(
        _cuda.DTYPE_CODE[out.dtype], g.data_ptr(), out.data_ptr(),
        win_id.data_ptr(), delta.data_ptr(), B, V, H, D, _cuda.stream(out))
    band_attention_delta.launches += 1
    _cuda.check(code, name)
    return delta


band_attention_delta.launches = 0


def band_attention_fused_backward(q, k, v, win_id, key_valid, out, lse, g):
    """K8's backward: (dq, dk, dv) for the cotangent ``g`` of ``out``, in
    the inputs' dtype.  ``lse`` is the forward kernel's statistics (unused
    by the plain version).  On the card the prologue computes D, then one
    kernel the three gradients: bf16 on the tensor cores, f32 on the CUDA
    cores."""
    if q.device.type == "cpu":
        return band_attention_backward_plain(q, k, v, win_id, key_valid, out,
                                             g)
    name = "band_attention_fused_backward"
    B, V = _check(name, q, k, v, win_id, key_valid, out, g)
    H = q.shape[2]
    _cuda.require(lse is not None and lse.dtype == torch.float32
                  and lse.shape == (B, V, H),
                  f"{name}: lse must be the forward's f32 {(B, V, H)}")
    _cuda.require_cuda(name, q, lse)
    return _backward(q, k, v, win_id, key_valid, lse,
                     band_attention_delta(out, g, win_id), g)


def _backward(q, k, v, win_id, key_valid, lse, delta, g):
    """The backward kernel alone, from the prologue's ``delta``: (dq, dk,
    dv) on CUDA tensors that ``band_attention_fused_backward`` checked."""
    B, V, H, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    code = _cuda.library().geomae_band_attention_bwd(
        _cuda.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        win_id.data_ptr(), key_valid.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, V, H, D, _cuda.stream(q))
    band_attention_fused_backward.launches += 1
    _cuda.check(code, "band_attention_fused_backward")
    return dq, dk, dv


band_attention_fused_backward.launches = 0


class _BandAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, win_id, key_valid):
        out, lse = _forward(q, k, v, win_id, key_valid, stats=True)
        ctx.save_for_backward(q, k, v, win_id, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, win_id, key_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = band_attention_fused_backward(
            q, k, v, win_id, key_valid, out, lse, g.contiguous())
        return dq, dk, dv, None, None


def band_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         win_id: torch.Tensor,
                         key_valid: torch.Tensor) -> torch.Tensor:
    """K8.  q, k, v [B, V, H, D] contiguous, window-sorted; win_id int32
    [B, V] (INT32_MAX padding last); key_valid bool [B, V].  Returns the
    attention output [B, V, H, D] in v's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BandAttention.apply(q, k, v, win_id, key_valid)
    return _forward(q, k, v, win_id, key_valid, stats=False)[0]


band_attention_fused.launches = 0
band_attention_fused.stats = 0      # launches that wrote the statistics
