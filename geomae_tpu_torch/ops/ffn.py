"""K5 post_attention_block: the fused post-attention tail of an SST
encoder layer, the CUDA wrappers of its forward and backward and their
plain versions.

Replaces ``geomae_tpu/ops/pallas_ffn.py:post_attention_block`` (forward
and ``_backward``); the kernels are ``csrc/post_attention.cuh``, a
translation unit a width (``csrc/post_attention_c*_f*.cu``).  Per
token:

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
or raises.  The kernels take (C, F) in ``KERNEL_WIDTHS`` (C of 128, 256,
384, 512, 640, 768 or 1024 with F of 1, 2, 3 or 4 times C) in float32 or
bfloat16.
Under grad the block is an ``autograd.Function`` whose backward
(``post_attention_block_backward``)
returns dx, dattn and the ten parameter gradients in f32 with the dtype
points of ``pallas_ffn._bwd_body``; rows at or past ``nv`` give zero dx
and dattn and add nothing to the parameter gradients.  In bfloat16 the
forward runs on the tensor cores (the first three stages of the
backward's per-tile pass, sharing its code; its plain version is
``post_attention_block_plain``), and the backward in two passes, whose
plain twins are
``post_attention_block_backward_tile_plain`` (per token tile: dx,
dattn, the bf16 rows the weight gradients need, the vector gradients)
and ``weight_grads_plain`` (the three weight gradients, split over token
chunks); in float32 each on the CUDA cores in one kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

# (C, F) the kernels take, F of 1, 2, 3 or 4 times C (at (512, 1536),
# (512, 2048), (640, 1280) and (640, 1920) the bf16 tile pass keeps one
# F-wide row a token of 16, not two: a1 waits in the da1 workspace; at
# the other widths of C 640 and more but (640, 640) and (768, 768) none:
# the hidden rows stream through a 128-column pass buffer,
# post_attention.cuh); the first is the shipped SST width, the rest by C,
# then F
KERNEL_WIDTHS = ((128, 256), (128, 128), (128, 384), (128, 512), (256, 256),
                 (256, 512), (256, 768), (256, 1024), (384, 384), (384, 768),
                 (384, 1152), (384, 1536), (512, 512), (512, 1024),
                 (512, 1536), (512, 2048), (640, 640), (640, 1280),
                 (640, 1920), (640, 2560), (768, 768), (768, 1536),
                 (768, 2304), (768, 3072), (1024, 1024), (1024, 2048),
                 (1024, 3072), (1024, 4096))
KERNEL_C, KERNEL_F = KERNEL_WIDTHS[0]
# the backward kernels run one block per SM, at most one a tile of 8
# tokens (post_attention.cuh, Widths: the tiles shrink as the rows widen,
# to 8 tokens in f32 at (384, 1152), (384, 1536), (512, 1024-2048) and 5
# widths of C 640 and more, 4 at the other 7; a tile of 4 is no fewer
# tiles than one of 8, and a block left without a tile writes zero
# partials); the bf16 weight gradients over chunks of 2,048 token rows
MIN_TILE = 8
BWD_BLOCKS_PER_SM = 1
WGRAD_CHUNK = 2048
PARAMS = ("wo", "bo", "s1", "t1", "w1", "b1", "w2", "b2", "s2", "t2")


def weight_floats(C: int, F: int) -> int:
    """The f32 weight gradients dWo, dW1, dW2 in one buffer."""
    return C * C + 2 * C * F


def grad_shapes(C: int, F: int) -> dict:
    """The f32 parameter gradients as the backward kernels lay them out."""
    return {"wo": (C, C), "w1": (C, F), "w2": (F, C), "bo": (C,),
            "s1": (C,), "t1": (C,), "b1": (F,), "b2": (C,), "s2": (C,),
            "t2": (C,)}


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


def _row_mask(x: torch.Tensor, nv) -> torch.Tensor:
    """[B, V, 1] bool: rows before ``nv`` (all rows when nv is None)."""
    if nv is None:
        return torch.ones(x.shape[:2] + (1,), dtype=torch.bool,
                          device=x.device)
    rows = torch.arange(x.shape[1], device=x.device)
    return (rows[None, :] < nv.to(x.device)[:, None])[..., None]


def post_attention_block_plain(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2,
                               t2, nv=None, eps: float = 1e-5):
    dt = x.dtype
    xm = fast_layer_norm(x + dense(attn, wo, bo), s1, t1, eps)
    h = F.gelu(dense(xm, w1, b1).float()).to(dt)
    y = fast_layer_norm(xm + dense(h, w2, b2), s2, t2, eps)
    if nv is None:
        return y
    return torch.where(_row_mask(x, nv), y, 0.0).to(dt)


def _ln_backward(z, dy, scale, eps):
    """(dz, xhat) of the LayerNorm over z's last axis, f32 in and out:
    dz = rs * (g - mean(g) - xhat * mean(g * xhat)), g = dy * scale."""
    mu = z.mean(-1, keepdim=True)
    rs = torch.rsqrt((z * z).mean(-1, keepdim=True) - mu * mu + eps)
    xhat = (z - mu) * rs
    g = dy * scale.float()
    dz = rs * (g - g.mean(-1, keepdim=True)
               - xhat * (g * xhat).mean(-1, keepdim=True))
    return dz, xhat


def post_attention_block_backward_tile_plain(x, attn, wo, bo, s1, t1, w1,
                                             b1, w2, b2, s2, t2, nv, dy,
                                             eps=1e-5, absolute=False):
    """The bf16 backward's per-tile pass: (dx, dattn) in x's dtype, the
    workspace rows (xm, da1, h, dz2) in x's dtype, 0 at rows past ``nv``,
    and the seven vector gradients (bo, s1, t1, b1, b2, s2, t2) in f32;
    with ``absolute``, each vector gradient's sum of its terms' absolute
    values instead."""
    dt = x.dtype
    rt = lambda t: t.to(dt).float()       # a cast to the compute dtype
    W = lambda w: w.to(dt).float()
    keep = _row_mask(x, nv)
    xf = torch.where(keep, x.float(), 0.0)
    af = torch.where(keep, attn.float(), 0.0)
    dyf = torch.where(keep, dy.float(), 0.0)
    # forward recompute (pallas_ffn._recompute)
    z = rt(xf + rt(rt(af @ W(wo)) + W(bo)))
    xm = rt(fast_layer_norm(z, s1, t1, eps))
    a1 = rt(rt(xm @ W(w1)) + W(b1))
    h = rt(F.gelu(a1))
    z2 = rt(xm + rt(rt(h @ W(w2)) + W(b2)))
    # backward (pallas_ffn._bwd_body)
    dz2, xh2 = _ln_backward(z2, dyf, s2, eps)
    dz2 = rt(dz2)
    cdf = 0.5 * (1.0 + torch.erf(a1 * 0.7071067811865476))
    pdf = torch.exp(-0.5 * a1 * a1) * 0.3989422804014327
    da1 = rt(rt(dz2 @ W(w2).t()) * (cdf + a1 * pdf))
    dxm = rt(dz2 + rt(da1 @ W(w1).t()))
    dz1, xh1 = _ln_backward(z, dxm, s1, eps)
    dz1 = rt(dz1)
    dattn = rt(dz1 @ W(wo).t())
    tsum = lambda t: (t.abs() if absolute else t).reshape(
        -1, t.shape[-1]).sum(0)
    vectors = (tsum(dz1), tsum(dxm * xh1), tsum(dxm), tsum(da1), tsum(dz2),
               tsum(dyf * xh2), tsum(dyf))
    rows = [torch.where(keep, t, 0.0).to(dt) for t in (dz1, dattn, xm, da1,
                                                       h, dz2)]
    return (*rows, *vectors)


def weight_grads_plain(attn, dx, xm, da1, h, dz2, nv, absolute=False):
    """The bf16 backward's weight-gradient pass: (dWo, dW1, dW2) = (attn^T
    dz1, xm^T da1, h^T dz2) in f32 over the rows before ``nv``, dz1 = dx;
    with ``absolute``, |attn|^T |dz1| and so on (each sum's terms'
    absolute values summed)."""
    keep = _row_mask(attn, nv)
    flat = lambda t: torch.where(keep, t.float().abs() if absolute
                                 else t.float(), 0.0).reshape(
        -1, t.shape[-1])
    return tuple(flat(a).t() @ flat(d)
                 for a, d in ((attn, dx), (xm, da1), (h, dz2)))


def post_attention_block_backward_plain(x, attn, wo, bo, s1, t1, w1, b1, w2,
                                        b2, s2, t2, nv, dy, eps=1e-5,
                                        absolute=False):
    """The backward kernel's function: (dx, dattn) in x's dtype and the ten
    parameter gradients (wo, bo, s1, t1, w1, b1, w2, b2, s2, t2) in f32;
    the composition of the bf16 kernel's two passes.  With ``absolute``
    each parameter gradient is the sum of its terms' absolute values (what
    a sum's forward-error bound scales with; ``probe_k5_backward``)."""
    dx, dattn, xm, da1, h, dz2, dbo, ds1, dt1, db1, db2, ds2, dt2 = \
        post_attention_block_backward_tile_plain(
            x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2, nv, dy, eps,
            absolute)
    dwo, dw1, dw2 = weight_grads_plain(attn, dx, xm, da1, h, dz2, nv,
                                       absolute)
    return (dx, dattn, dwo, dbo, ds1, dt1, dw1, db1, dw2, db2, ds2, dt2)


def _check_block(name, x, attn, w1, extra=()):
    """x, attn (and ``extra``) [B, V, C] on the card beside w1 [C, F], at a
    width the kernels take; returns (C, F)."""
    _cuda.require(x.device.type == "cuda",
                  f"{name}: no kernel for device {x.device}")
    widths = (x.shape[-1], w1.shape[-1]) if w1.dim() == 2 else None
    _cuda.require(x.dim() == 3 and widths in KERNEL_WIDTHS
                  and x.dtype in _cuda.DTYPE_CODE,
                  f"{name}: the kernel takes [B, V, C] float32 or bfloat16 "
                  f"with (C, F) in {KERNEL_WIDTHS}, got {x.dtype} "
                  f"{tuple(x.shape)} and w1 {tuple(w1.shape)}")
    for t in (attn, *extra):
        _cuda.require(t.shape == x.shape and t.dtype == x.dtype,
                      f"{name}: {t.dtype} {tuple(t.shape)} beside x")
    return widths


def _kernel_params(name, x, nv, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2):
    """The weights in the compute dtype, LayerNorm parameters in f32, nv
    int32 [B], all checked and contiguous."""
    B, V, C = x.shape
    Fd = w1.shape[-1]
    mats = [w.to(x.dtype).contiguous() for w in (wo, bo, w1, b1, w2, b2)]
    lns = [q.to(torch.float32).contiguous() for q in (s1, t1, s2, t2)]
    if nv is None:
        nv = torch.full((B,), V, dtype=torch.int32, device=x.device)
    _cuda.require_cuda(name, x, nv, *mats, *lns)
    shapes = [(C, C), (C,), (C, Fd), (Fd,), (Fd, C), (C,)]
    for w, shape in zip(mats, shapes):
        _cuda.require(w.shape == shape,
                      f"{name}: weight {tuple(w.shape)}, expected {shape}")
    for q in lns:
        _cuda.require(q.shape == (C,), f"{name}: LayerNorm {tuple(q.shape)}")
    _cuda.require(nv.dtype == torch.int32 and nv.shape == (B,),
                  f"{name}: nv must be int32 {(B,)}")
    return mats, lns, nv


def _forward(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2, nv, eps):
    if x.device.type == "cpu":
        return post_attention_block_plain(x, attn, wo, bo, s1, t1, w1, b1,
                                          w2, b2, s2, t2, nv, eps)
    name = "post_attention_block"
    C, Fd = _check_block(name, x, attn, w1)
    mats, lns, nv = _kernel_params(name, x, nv, wo, bo, s1, t1, w1, b1, w2,
                                   b2, s2, t2)
    _cuda.require_cuda(name, x, attn)
    wo, bo, w1, b1, w2, b2 = mats
    s1, t1, s2, t2 = lns
    B, V, _ = x.shape
    y = torch.empty_like(x)
    code = _cuda.library().geomae_post_attention_block(
        _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), attn.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), s1.data_ptr(), t1.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        s2.data_ptr(), t2.data_ptr(), nv.data_ptr(), y.data_ptr(), B, V, C,
        Fd, eps, _cuda.stream(x))
    post_attention_block.launches += 1
    _cuda.check(code, name)
    return y


def post_attention_block_backward(x, attn, wo, bo, s1, t1, w1, b1, w2, b2,
                                  s2, t2, nv, dy, eps: float = 1e-5):
    """K5 backward: (dx, dattn) [B, V, C] in x's dtype and the gradients of
    (wo, bo, s1, t1, w1, b1, w2, b2, s2, t2) in f32."""
    if x.device.type == "cpu":
        return post_attention_block_backward_plain(
            x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2, nv, dy, eps)
    name = "post_attention_block_backward"
    C, Fd = _check_block(name, x, attn, w1, (dy,))
    mats, lns, nv = _kernel_params(name, x, nv, wo, bo, s1, t1, w1, b1, w2,
                                   b2, s2, t2)
    _cuda.require_cuda(name, x, attn, dy)
    wo, bo, w1, b1, w2, b2 = mats
    s1, t1, s2, t2 = lns
    B, V, _ = x.shape
    shapes = grad_shapes(C, Fd)
    n = sum(torch.Size(s).numel() for s in shapes.values())
    n_weights = weight_floats(C, Fd)
    grads = torch.empty(n, dtype=torch.float32, device=x.device)
    dx, dattn = torch.empty_like(x), torch.empty_like(x)
    empty = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=x.device)
    lib = _cuda.library()
    if x.dtype == torch.bfloat16:
        # the tensor cores' two passes: per tile (dx, dattn, the bf16
        # workspace rows and the vector gradients), then the weight
        # gradients split over token chunks
        blocks = _cuda.persistent_blocks(x, BWD_BLOCKS_PER_SM,
                                         B * -(-V // MIN_TILE))
        widths = (C, Fd, Fd, C)
        xm, da1, h, dz2 = empty(B * V * sum(widths), dtype=x.dtype).split(
            [B * V * k for k in widths])      # [B * V, k] rows each
        vpartial = empty(blocks, n - n_weights)
        partial = empty(-(-B * V // WGRAD_CHUNK), n_weights)
        code = lib.geomae_post_attention_block_bwd_bf16(
            x.data_ptr(), attn.data_ptr(), dy.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), s1.data_ptr(), t1.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), s2.data_ptr(),
            t2.data_ptr(), nv.data_ptr(), dx.data_ptr(), dattn.data_ptr(),
            xm.data_ptr(), da1.data_ptr(), h.data_ptr(), dz2.data_ptr(),
            vpartial.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), B, V, C, Fd, eps, blocks, _cuda.stream(x))
    else:
        woT, w1T, w2T = (w.t().contiguous() for w in (wo, w1, w2))
        blocks = _cuda.persistent_blocks(x, BWD_BLOCKS_PER_SM,
                                         B * -(-V // MIN_TILE))
        partial = torch.zeros((blocks, n), dtype=torch.float32,
                              device=x.device)
        code = lib.geomae_post_attention_block_bwd(
            _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), attn.data_ptr(),
            dy.data_ptr(), wo.data_ptr(), bo.data_ptr(), s1.data_ptr(),
            t1.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), s2.data_ptr(), t2.data_ptr(), woT.data_ptr(),
            w1T.data_ptr(), w2T.data_ptr(), nv.data_ptr(), dx.data_ptr(),
            dattn.data_ptr(), partial.data_ptr(), grads.data_ptr(), B, V,
            C, Fd, eps, blocks, _cuda.stream(x))
    post_attention_block_backward.launches += 1
    _cuda.check(code, name)
    parts = dict(zip(shapes, grads.split(
        [torch.Size(s).numel() for s in shapes.values()])))
    return (dx, dattn, *[parts[k].view(shapes[k]) for k in PARAMS])


post_attention_block_backward.launches = 0


def weight_grads(attn, dx, xm, da1, h, dz2, nv):
    """The bf16 backward's weight-gradient pass alone (it runs inside
    ``post_attention_block_backward``): (dWo, dW1, dW2) in f32 from bf16
    token rows [B, V, k] or [B * V, k]; nv int32 [B] with ``attn`` [B, V,
    C] fixing B, V and C and ``da1`` F."""
    if attn.device.type == "cpu":
        return weight_grads_plain(attn, dx, xm, da1, h, dz2, nv)
    name = "weight_grads"
    B, V, C = attn.shape
    Fd = da1.shape[-1]
    rows = (attn, dx, xm, da1, h, dz2)
    _cuda.require_cuda(name, *rows, nv)
    _cuda.require((C, Fd) in KERNEL_WIDTHS,
                  f"{name}: (C, F) = {(C, Fd)} not in {KERNEL_WIDTHS}")
    for t, k in zip(rows, (C, C, C, Fd, Fd, C)):
        _cuda.require(t.dtype == torch.bfloat16 and t.numel() == B * V * k,
                      f"{name}: bfloat16 rows [{B * V}, {k}], got {t.dtype} "
                      f"{tuple(t.shape)}")
    _cuda.require(nv.dtype == torch.int32 and nv.shape == (B,),
                  f"{name}: nv must be int32 {(B,)}")
    n = weight_floats(C, Fd)
    grads = torch.empty(n, dtype=torch.float32, device=attn.device)
    partial = torch.empty((-(-B * V // WGRAD_CHUNK), n),
                          dtype=torch.float32, device=attn.device)
    code = _cuda.library().geomae_post_attention_wgrad_bf16(
        *[t.data_ptr() for t in rows], nv.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), B, V, C, Fd, _cuda.stream(attn))
    weight_grads.launches += 1
    _cuda.check(code, name)
    shapes = grad_shapes(C, Fd)
    return tuple(g.view(shapes[k]) for k, g in zip(
        ("wo", "w1", "w2"), grads.split([C * C, C * Fd, Fd * C])))


weight_grads.launches = 0


class _PostAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2, nv,
                eps):
        ctx.save_for_backward(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2,
                              t2, nv)
        ctx.eps = eps
        return _forward(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2, nv,
                        eps)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        grads = post_attention_block_backward(*saved, dy.contiguous(),
                                              ctx.eps)
        # parameter gradients leave in f32; cast only if a parameter is not
        cast = [g.to(p.dtype) for g, p in zip(grads[2:], saved[2:12])]
        return (*grads[:2], *cast, None, None)


def post_attention_block(x: torch.Tensor, attn: torch.Tensor, wo, bo, s1,
                         t1, w1, b1, w2, b2, s2, t2,
                         nv: torch.Tensor | None = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """x, attn [B, V, C]; wo [C, C], w1 [C, F], w2 [F, C] with biases;
    s1, t1, s2, t2 [C] LayerNorm scale and bias; nv int32 [B] or None
    (every row real).  Returns [B, V, C] in x's dtype.  Parameters may be
    f32: they are cast to x's dtype inside, and their gradients are f32."""
    args = (x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _PostAttentionBlock.apply(*args, nv, eps)
    return _forward(*args, nv, eps)


post_attention_block.launches = 0
