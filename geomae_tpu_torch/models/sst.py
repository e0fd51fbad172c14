"""SST encoder over window-sorted tokens (ungrouped).

Port of ``geomae_tpu/models/sst.py`` (``prepare_shift_data``,
``WindowMHA``, ``EncoderLayer``, ``BasicShiftBlock``, ``SSTStack``).
``attention_route`` and ``ffn_route`` resolve ``cfg.attention_impl`` and
``cfg.ffn_impl`` from the config alone, so the CPU and the GPU run one
model.  At the kernels' widths (C of 128, 256, 384 or 512 in heads of
8, 16, 32, 64 or 128; FFN of 1, 2, 3 or 4 times C, at C 512 of 1 or 2
times, GELU) an encoder layer is, by default, q/k/v projected by
``F.linear`` and then K8 (``ops/attention.py``), then K5
(``ops/ffn.py``: out-projection, residual, LN1, GELU FFN, residual, LN2);
``attention_impl="qkv"`` runs K6 (``ops/attention_qkv.py``: q/k/v
projections inside the window attention) instead, at C of 128 or 256.
At other widths the layer takes the plain ``band_attention`` and
the unfused chain in plain torch.  The parameter names are the same on every route, so one
``state_dict`` serves them all.  Tokens stay in window-sorted order
between layers: the stack permutes row-order tokens in once, each
layer applies one composed permutation from the previous layer's order,
and the stack permutes back at the end.

Submodule names follow the reference checkpoint
(``encoder_blocks.{i}.encoder_list.{j}.{win_attn.self_attn, linear1,
linear2, norm1, norm2}``); ``nn.MultiheadAttention`` only holds the fused
``in_proj`` and ``out_proj`` parameters that the kernels read.  Under
grad the same two calls are ``autograd.Function``s whose backward is K7
and K5's backward kernel, with f32 gradients for the f32 parameters.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import SSTConfig

from ..ops.attention import (band_attention, band_attention_fused,
                             kernel_takes)
from ..ops.attention_qkv import band_attention_qkv
from ..ops.attention_qkv import kernel_takes as qkv_kernel_takes
from ..ops.ffn import KERNEL_WIDTHS, post_attention_block
from ..ops.windows import INT32_MAX, WindowLayout, positional_embedding
from .norm import FastLayerNorm


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: x [B, V, ...], idx [B, V]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def prepare_shift_data(layouts: Sequence[WindowLayout],
                       key_valid: torch.Tensor, sst: SSTConfig) -> dict:
    """Per-shift sorted tensors and the composed permutations.

    Returns dict(layers=[per shift: win_id, pos_sorted, key_valid_sorted,
    extent], entry=(perm, inv) into the blocks' order, cross=[per layer
    (perm, inv) from the previous layer's order, or None])."""
    layers = []
    for lay in layouts:
        iota = torch.arange(lay.win_id.shape[-1], device=lay.win_id.device)
        extent = torch.where(lay.win_id != INT32_MAX, iota + 1, 0).amax(-1)
        layers.append(dict(
            win_id=lay.win_id,
            pos_sorted=positional_embedding(_take(lay.coors_in_win, lay.perm),
                                            sst),
            key_valid_sorted=_take(key_valid, lay.perm),
            extent=extent.to(torch.int32),
        ))
    n = len(layers)
    entry = (layouts[1 % n].perm, layouts[1 % n].inv_perm)

    def compose(a, b):            # tokens in order a -> order b
        if a is b:
            return None
        return (_take(a.inv_perm, b.perm), _take(b.inv_perm, a.perm))

    orders = [layouts[0], layouts[1 % n]]
    cross = [compose(orders[-1], orders[0]), compose(orders[0], orders[1])]
    return dict(layers=layers, entry=entry, cross=cross)


ATTENTION_IMPLS = ("auto", "qkv", "band", "pallas", "einsum")
FFN_IMPLS = ("auto", "fused", "xla")


def _check(field: str, value: str, names) -> None:
    if value not in names:
        raise ValueError(f"sst.{field}={value!r}: expected one of "
                         f"{sorted(names)}")


def attention_route(impl: str, d_model: int, nhead: int) -> str:
    """``attention_impl`` resolved: "qkv" (K6, projections inside the
    kernel), "band" (Linears, then K8) or "einsum" (Linears, then the plain
    band_attention).  K8, K6 and K7 take C of 128, 256, 384 or 512 in
    heads of 1, 2, 4, 8, 16, 32, 64 or 128, C 384 in 128 heads of 3, 64
    of 6, 32 of 12, 16 of 24, 8 of 48, 4 of 96 or 2 of 192, C 256 in one
    head of 256 or 512 in two, C 384 and 512 in one head, and C 640, 768
    and 1024 in heads of 8, 16, 32, 64 or 128 (``attention.kernel_takes``,
    ``attention_qkv.kernel_takes``): there "qkv" resolves to itself and
    every other kernel name to "band".  At any other width every name
    resolves to "einsum".  geomae_tpu/models/sst.py keeps its kernel
    routes for any C a multiple of 128 and any head count (and V of 128,
    a fact of the TPU's tiling: the port's kernels take any V), so the
    port serves on the plain routes what JAX serves on kernels at the
    other head widths of C 640 to 1024 and at C above 1024.  "auto" is
    "band" (choosing between band and qkv by speed is open: PERF.md)."""
    _check("attention_impl", impl, ATTENTION_IMPLS)
    if impl == "einsum" or not kernel_takes(d_model, nhead):
        return "einsum"
    if impl == "qkv":
        return "qkv" if qkv_kernel_takes(d_model, nhead) else "einsum"
    return "band"


def ffn_route(cfg: SSTConfig) -> str:
    """``cfg.ffn_impl`` resolved: "fused" (K5) for GELU at the kernel's
    widths, (C, F) in ``ffn.KERNEL_WIDTHS`` (C of 128, 256, 384, 512, 640,
    768 or 1024, F of 1, 2, 3 or 4 times C), else "xla" (the unfused
    chain).  JAX fuses GELU at any C a multiple of 128 and any F; the port
    serves on the unfused chain what JAX fuses at F not a multiple of 128,
    below C or above 4 C, and at C above 1024."""
    _check("ffn_impl", cfg.ffn_impl, FFN_IMPLS)
    _check("activation", cfg.activation, ("gelu", "relu"))
    fits = (cfg.d_model, cfg.dim_feedforward) in KERNEL_WIDTHS \
        and cfg.activation == "gelu"
    return "fused" if fits and cfg.ffn_impl != "xla" else "xla"


def _dense(t: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """A Linear outside the kernels, at their dtype points (and flax
    ``Dense``'s): the parameters cast to t's dtype, the product rounded to
    it, then the bias added in it.  ``weight`` is [out, in]."""
    return F.linear(t, weight.to(t.dtype)) + bias.to(t.dtype)


class WindowMHA(nn.Module):
    """Window attention on the route ``attention_impl`` names; returns the
    output before the out-projection, which the encoder layer applies."""

    def __init__(self, d_model: int, nhead: int, device=None,
                 attention_impl: str = "auto"):
        super().__init__()
        self.nhead = nhead
        self.route = attention_route(attention_impl, d_model, nhead)
        self.self_attn = nn.MultiheadAttention(d_model, nhead, dropout=0.0,
                                               device=device)

    def forward(self, x_s: torch.Tensor, layer: dict) -> torch.Tensor:
        B, V, C = x_s.shape
        w = self.self_attn.in_proj_weight        # [3C, C] (out x in)
        b = self.self_attn.in_proj_bias
        q, k, v = (slice(0, C), slice(C, 2 * C), slice(2 * C, 3 * C))
        win_id, key_valid = layer["win_id"], layer["key_valid_sorted"]
        if self.route == "qkv":
            return band_attention_qkv(
                x_s, layer["pos_sorted"], w[q].t(), b[q], w[k].t(), b[k],
                w[v].t(), b[v], win_id, key_valid, self.nhead)
        # q and k see x + pos, v sees x; three products, each output
        # contiguous as the kernel takes it
        qk_in = x_s + layer["pos_sorted"].to(x_s.dtype)
        shape = (B, V, self.nhead, C // self.nhead)
        qh, kh, vh = (_dense(t, w[rows], b[rows]).reshape(shape)
                      for t, rows in ((qk_in, q), (qk_in, k), (x_s, v)))
        attend = band_attention_fused if self.route == "band" \
            else band_attention
        return attend(qh, kh, vh, win_id, key_valid).reshape(B, V, C)


class EncoderLayer(nn.Module):
    """Attention + FFN with post-norm residuals, on tokens in this layer's
    window-sorted order, on the routes ``attention_route`` and
    ``ffn_route`` resolve."""

    def __init__(self, cfg: SSTConfig, device=None):
        super().__init__()
        C, Fd = cfg.d_model, cfg.dim_feedforward
        self.fused = ffn_route(cfg) == "fused"
        self.act = F.gelu if cfg.activation == "gelu" else F.relu
        self.win_attn = WindowMHA(C, cfg.nhead, device, cfg.attention_impl)
        self.linear1 = nn.Linear(C, Fd, device=device)
        self.linear2 = nn.Linear(Fd, C, device=device)
        self.norm1 = FastLayerNorm(C, eps=1e-5, device=device)
        self.norm2 = FastLayerNorm(C, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, layer: dict) -> torch.Tensor:
        attn = self.win_attn(x, layer)
        out = self.win_attn.self_attn.out_proj
        if self.fused:
            return post_attention_block(
                x, attn, out.weight.t(), out.bias, self.norm1.weight,
                self.norm1.bias, self.linear1.weight.t(), self.linear1.bias,
                self.linear2.weight.t(), self.linear2.bias,
                self.norm2.weight, self.norm2.bias, layer["extent"],
                self.norm1.eps)
        lin = lambda m, t: _dense(t, m.weight, m.bias)
        x = self.norm1(x + lin(out, attn))
        return self.norm2(x + lin(self.linear2, self.act(lin(self.linear1,
                                                             x))))


class BasicShiftBlock(nn.Module):
    """Two encoder layers: unshifted, then shifted windows.  Enters and
    leaves in the last shift's order."""

    def __init__(self, cfg: SSTConfig, device=None):
        super().__init__()
        self.encoder_list = nn.ModuleList(
            [EncoderLayer(cfg, device) for _ in range(2)])

    def forward(self, x: torch.Tensor, shift_data: dict) -> torch.Tensor:
        layers = shift_data["layers"]
        for i, enc in enumerate(self.encoder_list):
            cross = shift_data["cross"][i]
            if cross is not None:
                x = _take(x, cross[0])
            x = enc(x, layers[i % len(layers)])
        return x


class SSTStack(nn.ModuleList):
    """A stack of BasicShiftBlocks sharing one shift data; a ModuleList so
    its blocks carry the reference's ``encoder_blocks.{i}`` names."""

    def __init__(self, cfg: SSTConfig, num_blocks: int, device=None):
        super().__init__([BasicShiftBlock(cfg, device)
                          for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor, shift_data: dict) -> torch.Tensor:
        """x [B, V, C] in row order -> [B, V, C] in row order."""
        if len(self) == 0:
            return x
        perm, inv = shift_data["entry"]
        x = _take(x, perm)
        for block in self:
            x = block(x, shift_data)
        return _take(x, inv)
