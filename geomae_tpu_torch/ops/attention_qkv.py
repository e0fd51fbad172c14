"""K6 band_attention_qkv: window attention with in-kernel q/k/v
projections, the CUDA wrapper and its plain version.

Replaces ``geomae_tpu/ops/pallas_attention_qkv.py:band_attention_qkv``
(forward); the kernel is ``csrc/window_attention.cu``.  Computes, over
window-sorted tokens,

    q = (x + pos) Wq + bq,   k = (x + pos) Wk + bk,   v = x Wv + bv
    out = per head softmax(q k^T / sqrt(D) + mask) v

and returns the attention output BEFORE the out-projection (that one is
inside K5, ``ops/ffn.py``).  Weights are [C_in, C_out] as in the JAX
package, without its group axis.  ``pos`` is cast to x's dtype; the
projections accumulate in f32, cast to x's dtype, then add the bias in
that dtype (``pallas_attention_qkv._proj``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  The kernel takes C = 128 in 8 heads of 16 (the shipped
SST width) in float32 or bfloat16; windows may be of any size.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import band_attention
from .ffn import dense

KERNEL_C = 128
KERNEL_HEADS = 8


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


def band_attention_qkv(x: torch.Tensor, pos: torch.Tensor, wq, bq, wk, bk,
                       wv, bv, win_id: torch.Tensor, key_valid: torch.Tensor,
                       nheads: int) -> torch.Tensor:
    """x, pos [B, V, C]; W* [C, C]; b* [C]; win_id int32 [B, V] (window-
    sorted, INT32_MAX padding last); key_valid bool [B, V].  Returns the
    pre-out-projection attention output [B, V, C] in x's dtype."""
    if x.device.type == "cpu":
        return band_attention_qkv_plain(x, pos, wq, bq, wk, bk, wv, bv,
                                        win_id, key_valid, nheads)
    name = "band_attention_qkv"
    _cuda.require(x.device.type == "cuda",
                  f"{name}: no kernel for device {x.device}")
    _cuda.require(x.dim() == 3 and x.shape[2] == KERNEL_C
                  and nheads == KERNEL_HEADS and x.dtype in _cuda.DTYPE_CODE,
                  f"{name}: the kernel takes [B, V, {KERNEL_C}] float32 or "
                  f"bfloat16 in {KERNEL_HEADS} heads, got {x.dtype} "
                  f"{tuple(x.shape)} in {nheads}")
    B, V, C = x.shape
    dt = x.dtype
    pos = pos.to(dt)
    ws = [w.to(dt).contiguous() for w in (wq, bq, wk, bk, wv, bv)]
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
    out = torch.empty_like(x)
    code = _cuda.library().geomae_band_attention_qkv(
        _cuda.DTYPE_CODE[dt], x.data_ptr(), pos.data_ptr(),
        *[w.data_ptr() for w in ws], win_id.data_ptr(),
        key_valid.data_ptr(), out.data_ptr(), B, V, _cuda.stream(x))
    band_attention_qkv.launches += 1
    _cuda.check(code, name)
    return out


band_attention_qkv.launches = 0
