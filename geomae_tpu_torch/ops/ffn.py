"""K5 post_attention_block: the fused post-attention tail of an SST
encoder layer, the CUDA wrapper and its plain version.

Replaces ``geomae_tpu/ops/pallas_ffn.py:post_attention_block`` (forward);
the kernel is ``csrc/post_attention.cu``.  Per token:

    o  = attn Wo + bo;   xm = LN1(x + o)
    y  = LN2(xm + gelu(xm W1 + b1) W2 + b2)

with the dtype points of ``pallas_ffn._recompute``: matmuls accumulate in
f32 and cast to x's dtype before the bias is added in that dtype;
LayerNorm statistics are f32 with ``var = E[z^2] - mu^2``; GELU is the
exact erf form.  Weights are [C_in, C_out] without the JAX group axis.
Rows at or past ``nv[b]`` (the extent of the real tokens) return 0; the
TPU kernel zeroes whole tiles past ``nv``, and the rows between ``nv`` and
its tile's end are padding tokens that no consumer reads.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  The kernel takes C = 128, F = 256 (the shipped SST widths) in
float32 or bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

KERNEL_C = 128
KERNEL_F = 256


def dense(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``t @ w + b`` with the kernels' dtype points: w cast to t's dtype,
    f32 accumulation, the product cast to t's dtype, then the bias added
    in that dtype."""
    dt = t.dtype
    return (t.float() @ w.to(dt).float()).to(dt) + b.to(dt)


def fast_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics,
    ``var = E[x^2] - mu^2``; output in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def post_attention_block_plain(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2,
                               t2, nv=None, eps: float = 1e-5):
    dt = x.dtype
    xm = fast_layer_norm(x + dense(attn, wo, bo), s1, t1, eps)
    h = F.gelu(dense(xm, w1, b1).float()).to(dt)
    y = fast_layer_norm(xm + dense(h, w2, b2), s2, t2, eps)
    if nv is None:
        return y
    rows = torch.arange(x.shape[1], device=x.device)
    keep = rows[None, :] < nv.to(x.device)[:, None]
    return torch.where(keep[..., None], y, 0.0).to(dt)


def post_attention_block(x: torch.Tensor, attn: torch.Tensor, wo, bo, s1,
                         t1, w1, b1, w2, b2, s2, t2,
                         nv: torch.Tensor | None = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """x, attn [B, V, C]; wo [C, C], w1 [C, F], w2 [F, C] with biases;
    s1, t1, s2, t2 [C] LayerNorm scale and bias; nv int32 [B] or None
    (every row real).  Returns [B, V, C] in x's dtype."""
    if x.device.type == "cpu":
        return post_attention_block_plain(x, attn, wo, bo, s1, t1, w1, b1,
                                          w2, b2, s2, t2, nv, eps)
    name = "post_attention_block"
    _cuda.require(x.device.type == "cuda",
                  f"{name}: no kernel for device {x.device}")
    _cuda.require(x.dim() == 3 and x.shape[2] == KERNEL_C
                  and x.dtype in _cuda.DTYPE_CODE,
                  f"{name}: the kernel takes [B, V, {KERNEL_C}] float32 or "
                  f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    B, V, C = x.shape
    dt = x.dtype
    mats = [w.to(dt).contiguous() for w in (wo, bo, w1, b1, w2, b2)]
    lns = [p.to(torch.float32).contiguous() for p in (s1, t1, s2, t2)]
    if nv is None:
        nv = torch.full((B,), V, dtype=torch.int32, device=x.device)
    _cuda.require_cuda(name, x, attn, nv, *mats, *lns)
    _cuda.require(attn.shape == x.shape and attn.dtype == dt,
                  f"{name}: attn {attn.dtype} {tuple(attn.shape)}")
    shapes = [(C, C), (C,), (C, KERNEL_F), (KERNEL_F,), (KERNEL_F, C), (C,)]
    for w, shape in zip(mats, shapes):
        _cuda.require(w.shape == shape,
                      f"{name}: weight {tuple(w.shape)}, expected {shape}")
    for p in lns:
        _cuda.require(p.shape == (C,), f"{name}: LayerNorm {tuple(p.shape)}")
    _cuda.require(nv.dtype == torch.int32 and nv.shape == (B,),
                  f"{name}: nv must be int32 {(B,)}")
    wo, bo, w1, b1, w2, b2 = mats
    s1, t1, s2, t2 = lns
    y = torch.empty_like(x)
    code = _cuda.library().geomae_post_attention_block(
        _cuda.DTYPE_CODE[dt], x.data_ptr(), attn.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), s1.data_ptr(), t1.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), s2.data_ptr(),
        t2.data_ptr(), nv.data_ptr(), y.data_ptr(), B, V, eps,
        _cuda.stream(x))
    post_attention_block.launches += 1
    _cuda.check(code, name)
    return y


post_attention_block.launches = 0
