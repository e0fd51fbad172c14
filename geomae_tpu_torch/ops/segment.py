"""K1 segment_reduce and K2 segment_broadcast: CUDA wrappers and their
plain versions.

Replaces ``geomae_tpu/ops/pallas_segreduce.py`` (``segment_reduce_pallas``,
``segment_broadcast_pallas``) and their channel-major twins in
``pallas_segreduce_t.py``; the kernels are ``csrc/segment.cu``.

Contract of ``seg`` [B, P] int32: per batch row the ids ascend and are
dense ranks, and the rows with ``seg >= num_segments`` (invalid points and
capacity overflow, ``ops/voxelize.py``) form a suffix.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from . import _cuda, scatter

NEG_FILL = -3.0e38        # empty rows of a max reduce, as on the TPU
_OPS = {"sum": 0, "mean": 1, "max": 2}


def segment_reduce_plain(x: torch.Tensor, seg: torch.Tensor,
                         num_segments: int, op: str) -> torch.Tensor:
    """[B, P, C] -> [B, V, C] float32 sum or max over segment ids; empty
    rows are 0 (sum) or -3e38 (max)."""
    outs = []
    for xb, sb in zip(x.float(), seg):
        if op == "sum":
            outs.append(scatter.segment_sum(xb, sb, num_segments))
        else:
            outs.append(scatter.segment_max(xb, sb, num_segments,
                                            empty_value=NEG_FILL))
    return torch.stack(outs)


def segment_broadcast_plain(x: torch.Tensor, seg: torch.Tensor,
                            num_segments: int, op: str) -> torch.Tensor:
    """``out[b, t] = op over q with seg[b, q] == seg[b, t] of x[b, q]`` in
    x's dtype (f32 accumulation); rows with ``seg >= num_segments`` are 0."""
    outs = []
    for xb, sb in zip(x.float(), seg):
        if op == "max":
            table = scatter.segment_max(xb, sb, num_segments)
        elif op == "mean":
            table = scatter.segment_mean(xb, sb, num_segments)[0]
        else:
            table = scatter.segment_sum(xb, sb, num_segments)
        outs.append(scatter.gather_rows(table, sb))
    return torch.stack(outs).to(x.dtype)


def _check(name: str, x: torch.Tensor, seg: torch.Tensor,
           num_segments: int, op: str, ops) -> None:
    _cuda.require(op in ops, f"{name}: op {op!r} not in {ops}")
    if x.device.type == "cpu":
        return
    _cuda.require(x.device.type == "cuda",
                  f"{name}: no kernel for device {x.device}")
    _cuda.require_cuda(name, x, seg)
    _cuda.require(x.dim() == 3 and x.dtype in _cuda.DTYPE_CODE,
                  f"{name}: x must be [B, P, C] float32 or bfloat16, got "
                  f"{x.dtype} {tuple(x.shape)}")
    _cuda.require(seg.dtype == torch.int32 and seg.shape == x.shape[:2],
                  f"{name}: seg must be int32 {tuple(x.shape[:2])}, got "
                  f"{seg.dtype} {tuple(seg.shape)}")
    _cuda.require(min(x.shape) > 0 and num_segments > 0
                  and x.numel() < 2 ** 31,
                  f"{name}: empty or oversized input {tuple(x.shape)}")


def segment_reduce(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
                   op: str) -> torch.Tensor:
    """K1: segment sum or max, [B, P, C] -> [B, V, C] float32."""
    _check("segment_reduce", x, seg, num_segments, op, ("sum", "max"))
    if x.device.type == "cpu":
        return segment_reduce_plain(x, seg, num_segments, op)
    B, P, C = x.shape
    out = torch.empty((B, num_segments, C), dtype=torch.float32,
                      device=x.device)
    code = _cuda.library().geomae_segment_reduce(
        _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), seg.data_ptr(),
        out.data_ptr(), B, P, C, num_segments, _OPS[op], _cuda.stream(x))
    segment_reduce.launches += 1
    _cuda.check(code, "segment_reduce")
    return out


segment_reduce.launches = 0


def segment_broadcast(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
                      op: str) -> torch.Tensor:
    """K2: per-point segment sum, mean or max, [B, P, C] -> [B, P, C] in
    x's dtype; rows with ``seg >= num_segments`` are 0."""
    _check("segment_broadcast", x, seg, num_segments, op, tuple(_OPS))
    if x.device.type == "cpu":
        return segment_broadcast_plain(x, seg, num_segments, op)
    B, P, C = x.shape
    out = torch.empty_like(x)
    code = _cuda.library().geomae_segment_broadcast(
        _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), seg.data_ptr(),
        out.data_ptr(), B, P, C, num_segments, _OPS[op], _cuda.stream(x))
    segment_broadcast.launches += 1
    _cuda.check(code, "segment_broadcast")
    return out


segment_broadcast.launches = 0
