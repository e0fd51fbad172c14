"""Masked segment reductions and row gathers.

Port of ``geomae_tpu/ops/scatter.py``.  Each function but
``gather_injective`` works on one sample (segment axis first) with the
JAX function's semantics: ids outside ``[0, num_segments)`` or marked
invalid go to a trash row that is dropped, and gathers at out-of-range
ids return ``fill``.  The JAX module's sorted-id paths (cumsum sums,
associative-scan maxima, the centred mean) and most of its custom VJPs
exist to keep XLA's TPU lowering off scatters and to shape the backward;
``index_add_`` and ``scatter_reduce_`` compute the same forward for any id
order, so there is one path here, forward only.  These are the plain
versions that the segment kernels (``ops/segment.py``) are held to.
``take_rows_sorted`` differs from ``gather_rows`` only in its VJP and is
not ported.  ``gather_injective`` keeps its VJP, an inverse gather, as an
``autograd.Function`` over a batch axis.
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


def gather_rows_batched(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x [B, N, ...] at idx [B, M] -> [B, M, ...]; ids outside
    [0, N) read 0."""
    N = x.shape[1]
    ok = (idx >= 0) & (idx < N)
    safe = idx.clamp(0, N - 1).long()
    tail = (1,) * (x.dim() - 2)
    rows = torch.gather(x, 1, safe.reshape(safe.shape + tail).expand(
        safe.shape + x.shape[2:]))
    return torch.where(ok.reshape(ok.shape + tail), rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _GatherInjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return gather_rows_batched(x, idx)

    @staticmethod
    def backward(ctx, g):
        (inv_idx,) = ctx.saved_tensors
        return gather_rows_batched(g, inv_idx), None, None


def gather_injective(x: torch.Tensor, idx: torch.Tensor,
                     inv_idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather ``x[b, idx[b]]`` (out-of-range ids read 0) whose
    backward is the inverse gather ``g[b, inv_idx[b]]``.  x [B, N, ...],
    idx [B, M], inv_idx [B, N].

    Valid when the in-range entries of ``idx`` are unique (an injection:
    a compaction list, an expansion map) and ``inv_idx`` is its inverse:
    ``inv_idx[idx[s]] == s`` for every in-range ``idx[s]``, and rows of
    ``x`` that ``idx`` never reads hold out-of-range ``inv_idx`` entries.
    The transpose of an injective gather is then itself a gather, so the
    backward accumulates nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherInjective.apply(x, idx, inv_idx)
    return gather_rows_batched(x, idx)
