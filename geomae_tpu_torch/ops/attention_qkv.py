"""K6 band_attention_qkv: window attention with in-kernel q/k/v
projections; the CUDA wrappers of its forward (K6) and backward (K7) and
their plain versions.

Replaces ``geomae_tpu/ops/pallas_attention_qkv.py:band_attention_qkv``
(forward, and its backward ``_pallas_backward_merged`` /
``_pallas_backward_split``); the kernels are ``csrc/window_attention.cu``.
Computes, over window-sorted tokens,

    q = (x + pos) Wq + bq,   k = (x + pos) Wk + bk,   v = x Wv + bv
    out = per head softmax(q k^T / sqrt(D) + mask) v

and returns the attention output BEFORE the out-projection (that one is
inside K5, ``ops/ffn.py``).  Weights are [C_in, C_out] as in the JAX
package, without its group axis.  ``pos`` is cast to x's dtype; the
projections accumulate in f32, cast to x's dtype, then add the bias in
that dtype (``pallas_attention_qkv._proj``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  The kernels take C = 128 in 8 heads of 16 (the shipped
SST width) in float32 or bfloat16; windows may be of any size.

Under grad the attention is an ``autograd.Function``: the forward kernel
also writes each (row, head)'s log-sum-exp of the scores ([B, V, 8] f32),
and the backward (``band_attention_qkv_backward``) returns dx, which sums
the query-side and key-side terms, and dWq, dbq, dWk, dbk, dWv, dbv in
f32.  ``pos`` gets no cotangent, as in the JAX package.  Without grad the
forward launches without the statistics, as in serving.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import band_attention, plain_blocks, plain_lse
from .ffn import dense

KERNEL_C = 128
KERNEL_HEADS = 8
BWD_BLOCKS_PER_SM = 2     # the backward kernel's 98 KB of shared memory


def _scale_pow2(head_dim: int) -> bool:
    """1/sqrt(head_dim) is a power of two (head_dim a power of four):
    folding the scale into q is then exact in any float dtype."""
    lb = head_dim.bit_length() - 1
    return head_dim == (1 << lb) and lb % 2 == 0


def band_attention_qkv_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                             key_valid, nheads: int) -> torch.Tensor:
    B, V, C = x.shape
    D = C // nheads
    xp = x + pos.to(x.dtype)
    q = dense(xp, wq, bq)
    k = dense(xp, wk, bk)
    v = dense(x, wv, bv)
    scale = D ** -0.5
    if _scale_pow2(D):
        q, scale = q * scale, 1.0
    shape = (B, V, nheads, D)
    out = band_attention(q.reshape(shape), k.reshape(shape),
                         v.reshape(shape), win_id, key_valid, scale)
    return out.reshape(B, V, C)


def _plain_qkv(x, pos, wq, bq, wk, bk, wv, bv, nheads: int):
    """(x + pos, q, k, v, scale, fold): q, k, v f32 [B, V, H, D] as the
    kernels round them, q already scaled when ``fold``."""
    B, V, C = x.shape
    D = C // nheads
    dt = x.dtype
    xp = x + pos.to(dt)
    q, k, v = (dense(xp, wq, bq).float(), dense(xp, wk, bk).float(),
               dense(x, wv, bv).float())
    scale = D ** -0.5
    fold = _scale_pow2(D)
    if fold:
        q = (q * scale).to(dt).float()
    shape = (B, V, nheads, D)
    return (xp, q.reshape(shape), k.reshape(shape), v.reshape(shape), scale,
            fold)


def band_attention_qkv_lse_plain(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                                 key_valid, nheads: int) -> torch.Tensor:
    """The forward kernel's statistics under grad: per (row, head) the
    log-sum-exp of the masked, scaled scores, [B, V, H] f32; 0 for a
    padding row or a row with no valid key."""
    _, q, k, _, scale, fold = _plain_qkv(x, pos, wq, bq, wk, bk, wv, bv,
                                         nheads)
    return plain_lse(q, k, win_id, key_valid, 1.0 if fold else scale)


def band_attention_qkv_backward_plain(x, pos, wq, bq, wk, bk, wv, bv,
                                      win_id, key_valid, nheads: int, out,
                                      g):
    """The backward kernel's function: (dx, dWq, dbq, dWk, dbk, dWv, dbv),
    dx in x's dtype, the rest f32.  ``out`` is the forward's output and
    ``g`` its cotangent.  The softmax is recomputed exactly per window (as
    ``band_attention`` does); ds and p are rounded to x's dtype before
    their products, dq, dk and dv once at the end
    (``_bwd_merged_kernel``)."""
    B, V, C = x.shape
    dt = x.dtype
    rt = lambda t: t.to(dt).float()
    xp, q, k, v, scale, fold = _plain_qkv(x, pos, wq, bq, wk, bk, wv, bv,
                                          nheads)
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
    dqc = rt(dq.reshape(B, V, C) * scale)
    dkc = rt(dk.reshape(B, V, C) * (1.0 if fold else scale))
    dvc = rt(dv.reshape(B, V, C))
    W = lambda t: t.to(dt).float()
    dx = rt(rt(dqc @ W(wq).t()) + rt(dkc @ W(wk).t() + dvc @ W(wv).t()))
    flat = lambda t: t.float().reshape(-1, C)
    grads = []
    for a, d in ((xp, dqc), (xp, dkc), (x, dvc)):
        grads += [flat(a).t() @ flat(d), flat(d).sum(0)]
    return (dx.to(dt), *grads)


def _check_qkv(name, x, nheads):
    _cuda.require(x.device.type == "cuda",
                  f"{name}: no kernel for device {x.device}")
    _cuda.require(x.dim() == 3 and x.shape[2] == KERNEL_C
                  and nheads == KERNEL_HEADS and x.dtype in _cuda.DTYPE_CODE,
                  f"{name}: the kernel takes [B, V, {KERNEL_C}] float32 or "
                  f"bfloat16 in {KERNEL_HEADS} heads, got {x.dtype} "
                  f"{tuple(x.shape)} in {nheads}")


def _kernel_inputs(name, x, pos, ws, win_id, key_valid):
    """pos and the weights in x's dtype, all checked and contiguous."""
    B, V, C = x.shape
    pos = pos.to(x.dtype).contiguous()
    ws = [w.to(x.dtype).contiguous() for w in ws]
    _cuda.require_cuda(name, x, pos, win_id, key_valid, *ws)
    _cuda.require(pos.shape == x.shape, f"{name}: pos {tuple(pos.shape)}")
    for w, shape in zip(ws, [(C, C), (C,)] * 3):
        _cuda.require(w.shape == shape,
                      f"{name}: weight {tuple(w.shape)}, expected {shape}")
    _cuda.require(win_id.dtype == torch.int32 and win_id.shape == (B, V),
                  f"{name}: win_id must be int32 {(B, V)}")
    _cuda.require(key_valid.dtype == torch.bool
                  and key_valid.shape == (B, V),
                  f"{name}: key_valid must be bool {(B, V)}")
    return pos, ws


def _forward(x, pos, wq, bq, wk, bk, wv, bv, win_id, key_valid, nheads,
             stats: bool):
    """(out, lse): lse [B, V, 8] f32 when ``stats`` on a CUDA tensor, else
    None (the plain backward recomputes its softmax)."""
    if x.device.type == "cpu":
        return band_attention_qkv_plain(x, pos, wq, bq, wk, bk, wv, bv,
                                        win_id, key_valid, nheads), None
    name = "band_attention_qkv"
    _check_qkv(name, x, nheads)
    pos, ws = _kernel_inputs(name, x, pos, (wq, bq, wk, bk, wv, bv), win_id,
                             key_valid)
    B, V, _ = x.shape
    out = torch.empty_like(x)
    lse = (torch.empty((B, V, nheads), dtype=torch.float32, device=x.device)
           if stats else None)
    code = _cuda.library().geomae_band_attention_qkv(
        _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), pos.data_ptr(),
        *[w.data_ptr() for w in ws], win_id.data_ptr(),
        key_valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, V, _cuda.stream(x))
    band_attention_qkv.launches += 1
    band_attention_qkv.stats += lse is not None
    _cuda.check(code, name)
    return out, lse


def band_attention_qkv_backward(x, pos, wq, bq, wk, bk, wv, bv, win_id,
                                key_valid, nheads: int, out, lse, g):
    """K7: (dx, dWq, dbq, dWk, dbk, dWv, dbv) for the cotangent ``g`` of
    ``out``; dx in x's dtype, the rest f32.  ``lse`` is the forward
    kernel's statistics (unused by the plain version)."""
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
    _cuda.require(out.shape == x.shape and g.shape == x.shape
                  and out.dtype == x.dtype and g.dtype == x.dtype,
                  f"{name}: out and g must be {x.dtype} {tuple(x.shape)}")
    _cuda.require_cuda(name, x, out, lse, g)
    wT = [w.t().contiguous() for w in ws[0::2]]
    blocks = _cuda.persistent_blocks(x, BWD_BLOCKS_PER_SM, B * -(-V // 32))
    n = 3 * C * C + 3 * C
    partial = torch.zeros((blocks, n), dtype=torch.float32, device=x.device)
    grads = torch.empty(n, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    code = _cuda.library().geomae_band_attention_qkv_bwd(
        _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), pos.data_ptr(),
        *[w.data_ptr() for w in ws], *[w.data_ptr() for w in wT],
        win_id.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), B, V, blocks, _cuda.stream(x))
    band_attention_qkv_backward.launches += 1
    _cuda.check(code, name)
    dwq, dwk, dwv, dbq, dbk, dbv = grads.split([C * C] * 3 + [C] * 3)
    return (dx, dwq.view(C, C), dbq, dwk.view(C, C), dbk, dwv.view(C, C),
            dbv)


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
