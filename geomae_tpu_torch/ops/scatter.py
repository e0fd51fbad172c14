"""Masked segment reductions and row gathers, forward only.

Port of ``geomae_tpu/ops/scatter.py``.  Each function works on one sample
(segment axis first) with the JAX function's semantics: ids outside
``[0, num_segments)`` or marked invalid go to a trash row that is dropped,
and gathers at out-of-range ids return ``fill``.  The JAX module's
sorted-id paths (cumsum sums, associative-scan maxima, the centred mean)
and its custom VJPs exist to keep XLA's TPU lowering off scatters and to
shape the backward; ``index_add_`` and ``scatter_reduce_`` compute the
same forward for any id order, so there is one path here.  The JAX
``take_rows_sorted`` and ``gather_injective`` differ from ``gather_rows``
only in their custom VJPs, so ``gather_rows`` is their forward.  These are
the plain versions that the segment kernels (``ops/segment.py``) are held
to.
"""
from __future__ import annotations

import torch


def _route_invalid(seg_ids: torch.Tensor, valid: torch.Tensor | None,
                   num_segments: int) -> torch.Tensor:
    """int64 ids with invalid / out-of-range entries at ``num_segments``."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, seg_ids, num_segments).long()


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Masked segment sum: ``data`` [N, ...], ``seg_ids`` [N]."""
    ids = _route_invalid(seg_ids, valid, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids, data)[:num_segments]


def segment_count(seg_ids: torch.Tensor, num_segments: int,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Number of valid elements per segment, int32 [num_segments]."""
    ids = _route_invalid(seg_ids, valid, num_segments)
    return torch.bincount(ids, minlength=num_segments + 1)[
        :num_segments].to(torch.int32)


def segment_mean(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                 valid: torch.Tensor | None = None):
    """Masked segment mean in f32.  Returns ``(mean, count)``; empty
    segments are 0."""
    s = segment_sum(data.float(), seg_ids, num_segments, valid)
    c = segment_count(seg_ids, num_segments, valid)
    denom = c.clamp_min(1).to(torch.float32)
    return s / denom.reshape(denom.shape + (1,) * (s.dim() - 1)), c


def segment_max(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                valid: torch.Tensor | None = None,
                empty_value: float = 0.0) -> torch.Tensor:
    """Masked segment max; empty segments get ``empty_value``."""
    ids = _route_invalid(seg_ids, valid, num_segments)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = ids.reshape(ids.shape + (1,) * (data.dim() - 1)).expand_as(data)
    out = out.scatter_reduce_(0, idx, data, "amax")[:num_segments]
    c = segment_count(seg_ids, num_segments, valid)
    nonempty = (c > 0).reshape(c.shape + (1,) * (out.dim() - 1))
    return torch.where(nonempty, out, out.new_tensor(empty_value))


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Rows of ``table`` [S, ...] at ``idx`` [N]; ids outside ``[0, S)``
    return ``fill``."""
    S = table.shape[0]
    ok = (idx >= 0) & (idx < S)
    rows = table[idx.clamp(0, S - 1).long()]
    mask = ok.reshape(ok.shape + (1,) * (rows.dim() - 1))
    return torch.where(mask, rows, rows.new_tensor(fill))
