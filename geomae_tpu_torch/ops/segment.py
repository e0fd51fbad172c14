"""K1 segment_reduce, K2 segment_broadcast and the K1 gather
segment_gather: CUDA wrappers, their plain versions and their gradients.

Replaces ``geomae_tpu/ops/pallas_segreduce.py`` (``segment_reduce_pallas``,
``segment_broadcast_pallas``, ``segment_gather_pallas``) and their
channel-major twins in ``pallas_segreduce_t.py``; the kernels are
``csrc/segment.cu``.

Contract of ``seg`` [B, P] int32: per batch row the ids ascend and are
dense ranks, and the rows with ``seg >= num_segments`` (invalid points and
capacity overflow, ``ops/voxelize.py``) form a suffix.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Each wrapper counts its kernel's launches in
``<wrapper>.launches``.  Under grad the three are ``autograd.Function``s
whose backward is the JAX VJP (``_reduce_bwd``, ``_bcast_bwd``,
``_gather_bwd``), built from the same kernels, each with its plain
version (``segment_reduce_backward_plain``,
``segment_broadcast_backward_plain``):

* K1 sum: the gather of the cotangent;
* K1 max: one gather of [cotangent, max] to the points, masked by
  ``x == max``: every tied element gets the whole cotangent (PyTorch's
  own ``amax`` backward would split it among the ties);
* K2 sum / mean: K2 sum / mean of the cotangent; K2 max: K2 sum of the
  cotangent, masked by ``x == out``;
* the gather: K1 sum of the cotangent.

The cotangent dtypes follow the JAX package: K1 max rounds a bf16
payload's cotangent to bf16 before its gather, the others work in f32.
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


def segment_gather_plain(table: torch.Tensor,
                         seg: torch.Tensor) -> torch.Tensor:
    """``out[b, t] = table[b, seg[b, t]]`` in table's dtype; rows with
    ``seg`` outside ``[0, S)`` are 0."""
    return torch.stack([scatter.gather_rows(t, s)
                        for t, s in zip(table, seg)])


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


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _work(lib, x: torch.Tensor) -> torch.Tensor:
    """The kernels' workspace for x: the partials of the segments that a
    block's edge cuts, which a second kernel combines."""
    return torch.empty(lib.geomae_segment_work_bytes(*x.shape),
                       dtype=torch.uint8, device=x.device)


def _reduce(x, seg, num_segments, op):
    if x.device.type == "cpu":
        return segment_reduce_plain(x, seg, num_segments, op)
    B, P, C = x.shape
    out = torch.empty((B, num_segments, C), dtype=torch.float32,
                      device=x.device)
    lib = _cuda.library()
    code = lib.geomae_segment_reduce(
        _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), seg.data_ptr(),
        out.data_ptr(), B, P, C, num_segments, _OPS[op],
        _work(lib, x).data_ptr(), _cuda.stream(x))
    segment_reduce.launches += 1
    _cuda.check(code, "segment_reduce")
    return out


def _broadcast(x, seg, num_segments, op):
    if x.device.type == "cpu":
        return segment_broadcast_plain(x, seg, num_segments, op)
    B, P, C = x.shape
    out = torch.empty_like(x)
    lib = _cuda.library()
    code = lib.geomae_segment_broadcast(
        _cuda.DTYPE_CODE[x.dtype], x.data_ptr(), seg.data_ptr(),
        out.data_ptr(), B, P, C, num_segments, _OPS[op],
        _work(lib, x).data_ptr(), _cuda.stream(x))
    segment_broadcast.launches += 1
    _cuda.check(code, "segment_broadcast")
    return out


def _gather(table, seg):
    if table.device.type == "cpu":
        return segment_gather_plain(table, seg)
    B, S, C = table.shape
    P = seg.shape[1]
    out = torch.empty((B, P, C), dtype=table.dtype, device=table.device)
    code = _cuda.library().geomae_segment_gather(
        table.data_ptr(), seg.data_ptr(), out.data_ptr(), B, S, P,
        C * table.element_size(), _cuda.stream(table))
    segment_gather.launches += 1
    _cuda.check(code, "segment_gather")
    return out


def segment_reduce_backward_plain(x, seg, num_segments, op, out, g):
    """K1's backward (``_reduce_bwd``) on the plain ops: each point takes
    its segment's cotangent (sum), or the whole of it where it equals its
    segment's max (max: every tie).  A bf16 payload's cotangent is rounded
    to bf16 first."""
    if op == "sum":
        return segment_gather_plain(g.float(), seg).to(x.dtype)
    dx = []
    for xb, sb, ob, gb in zip(x.float(), seg, out, g.to(x.dtype).float()):
        top = scatter.gather_rows(ob, sb, fill=float("inf"))
        dx.append(torch.where(xb == top, scatter.gather_rows(gb, sb), 0.0))
    return torch.stack(dx).to(x.dtype)


def segment_reduce_backward(x, seg, num_segments, op, out, g):
    """K1's backward through the K1 gather: ``out`` is the forward's
    result, ``g`` its cotangent; returns dx in x's dtype."""
    if x.device.type == "cpu":
        return segment_reduce_backward_plain(x, seg, num_segments, op, out,
                                             g)
    if op == "sum":
        return segment_gather(g.float().contiguous(), seg).to(x.dtype)
    # one gather of [cotangent, max] in the payload's dtype
    C = x.shape[-1]
    both = segment_gather(torch.cat([g.to(x.dtype), out.to(x.dtype)], -1),
                          seg).float()
    ok = (seg >= 0) & (seg < num_segments)
    hit = (x.float() == both[..., C:]) & ok[..., None]
    return torch.where(hit, both[..., :C], 0.0).to(x.dtype)


def segment_broadcast_backward_plain(x, seg, num_segments, op, out, g):
    """K2's backward (``_bcast_bwd``) on the plain ops: the f32 segment sum
    of the cotangent, masked by ``x == out`` (max: every tie), or the
    cotangent's own segment sum / mean (sum-broadcast is self-adjoint,
    mean-broadcast's adjoint is mean-broadcast)."""
    if op == "max":
        gs = segment_broadcast_plain(g.float(), seg, num_segments, "sum")
        return torch.where(x.float() == out.float(), gs, 0.0).to(x.dtype)
    return segment_broadcast_plain(g.float(), seg, num_segments,
                                   op).to(g.dtype)


def segment_broadcast_backward(x, seg, num_segments, op, out, g):
    """K2's backward through K2 (its sum for max); returns dx."""
    if x.device.type == "cpu":
        return segment_broadcast_backward_plain(x, seg, num_segments, op,
                                                out, g)
    g32 = g.float().contiguous()
    if op == "max":
        gs = segment_broadcast(g32, seg, num_segments, "sum")
        return torch.where(x.float() == out.float(), gs, 0.0).to(x.dtype)
    return segment_broadcast(g32, seg, num_segments, op).to(g.dtype)


class _SegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, num_segments, op):
        out = _reduce(x, seg, num_segments, op)
        ctx.save_for_backward(x, seg, out)
        ctx.num_segments, ctx.op = num_segments, op
        return out

    @staticmethod
    def backward(ctx, g):
        x, seg, out = ctx.saved_tensors
        return segment_reduce_backward(x, seg, ctx.num_segments, ctx.op,
                                       out, g), None, None, None


class _SegmentBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, num_segments, op):
        out = _broadcast(x, seg, num_segments, op)
        ctx.save_for_backward(x, seg, out)
        ctx.num_segments, ctx.op = num_segments, op
        return out

    @staticmethod
    def backward(ctx, g):
        x, seg, out = ctx.saved_tensors
        return segment_broadcast_backward(x, seg, ctx.num_segments, ctx.op,
                                          out, g), None, None, None


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, seg):
        ctx.save_for_backward(seg)
        ctx.rows, ctx.dtype = table.shape[1], table.dtype
        return _gather(table, seg)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        dt = segment_reduce(g.float().contiguous(), seg, ctx.rows, "sum")
        return dt.to(ctx.dtype), None


def segment_reduce(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
                   op: str) -> torch.Tensor:
    """K1: segment sum or max, [B, P, C] -> [B, V, C] float32."""
    _check("segment_reduce", x, seg, num_segments, op, ("sum", "max"))
    if _needs_grad(x):
        return _SegmentReduce.apply(x, seg, num_segments, op)
    return _reduce(x, seg, num_segments, op)


segment_reduce.launches = 0


def segment_broadcast(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
                      op: str) -> torch.Tensor:
    """K2: per-point segment sum, mean or max, [B, P, C] -> [B, P, C] in
    x's dtype; rows with ``seg >= num_segments`` are 0."""
    _check("segment_broadcast", x, seg, num_segments, op, tuple(_OPS))
    if _needs_grad(x):
        return _SegmentBroadcast.apply(x, seg, num_segments, op)
    return _broadcast(x, seg, num_segments, op)


segment_broadcast.launches = 0


def segment_gather(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """K1 gather: ``out[b, t] = table[b, seg[b, t]]``, [B, S, C] -> [B, P,
    C] in table's dtype; rows with ``seg >= S`` are 0."""
    name = "segment_gather"
    if table.device.type != "cpu":
        _cuda.require(table.device.type == "cuda",
                      f"{name}: no kernel for device {table.device}")
        _cuda.require_cuda(name, table, seg)
        _cuda.require(table.dim() == 3 and table.dtype in _cuda.DTYPE_CODE
                      and min(table.shape) > 0,
                      f"{name}: table must be [B, S, C] float32 or bfloat16, "
                      f"got {table.dtype} {tuple(table.shape)}")
        _cuda.require(seg.dtype == torch.int32 and seg.dim() == 2
                      and seg.shape[0] == table.shape[0] and seg.shape[1] > 0,
                      f"{name}: seg must be int32 [{table.shape[0]}, P], got "
                      f"{seg.dtype} {tuple(seg.shape)}")
        _cuda.require(table.data_ptr() % 16 == 0,
                      f"{name}: table must be 16-byte aligned")
    if _needs_grad(table):
        return _SegmentGather.apply(table, seg)
    return _gather(table, seg)


segment_gather.launches = 0
