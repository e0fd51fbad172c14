"""K3 slot_outer_segment_sum and K4 expand_rows: CUDA wrappers and their
plain versions.

K3 replaces ``geomae_tpu/ops/pallas_segreduce.py:slot_outer_segment_sum_
pallas`` and its channel-major twin ``pallas_segreduce_t.slot_outer_
segment_sum_t`` (one kernel: the twin differs only in its input layout);
K4 replaces ``pallas_segreduce.py:expand_rows_pallas``.  The kernels are
``csrc/targets.cu``.  Both feed the geometric targets, which carry no
gradient, so neither has a backward.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from . import _cuda

SLOT_CHANNELS = 4           # (z, y, x, 1) per point
KERNEL_SLOTS = (32, 64, 96, 128)


def slot_outer_segment_sum_plain(vals: torch.Tensor, slot: torch.Tensor,
                                 seg: torch.Tensor, num_slots: int,
                                 num_segments: int) -> torch.Tensor:
    """``out[b, v, s, c] = sum_t vals[b, t, c] [seg[b, t] == v] [slot[b, t]
    == s]``, f32 [B, V, S, cv]: one ``index_add_`` over the flattened
    index ``v * S + s``; points with seg outside [0, V) go to a dropped
    trash row."""
    B, P, cv = vals.shape
    n = num_segments * num_slots
    ok = (seg >= 0) & (seg < num_segments)
    idx = torch.where(ok, seg.long() * num_slots + slot.long(), n)
    idx = idx + (n + 1) * torch.arange(B, device=vals.device)[:, None]
    out = torch.zeros((B * (n + 1), cv), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, idx.reshape(-1), vals.float().reshape(-1, cv))
    return out.view(B, n + 1, cv)[:, :n].reshape(B, num_segments, num_slots,
                                                 cv)


def expand_rows_plain(feats: torch.Tensor, key: torch.Tensor,
                      n_cells: int) -> torch.Tensor:
    """``out[b, key[b, r]] = feats[b, r]`` for keys in [0, n_cells), 0
    elsewhere, f32 [B, n_cells + 1, C]; row n_cells (the sentinel's) is
    0."""
    B, V, C = feats.shape
    ok = (key >= 0) & (key < n_cells)
    flat = key.long() + (n_cells + 1) * torch.arange(
        B, device=feats.device)[:, None]
    out = torch.zeros((B * (n_cells + 1), C), dtype=torch.float32,
                      device=feats.device)
    out[flat[ok]] = feats.float()[ok]
    return out.view(B, n_cells + 1, C)


def slot_outer_segment_sum(vals: torch.Tensor, slot: torch.Tensor,
                           seg: torch.Tensor, num_slots: int,
                           num_segments: int) -> torch.Tensor:
    """K3: vals [B, P, 4] f32, slot [B, P] int32 in [0, S), seg [B, P]
    int32 ascending per batch row (points with seg >= V dropped) -> f32
    [B, V, S, 4]."""
    if vals.device.type == "cpu":
        return slot_outer_segment_sum_plain(vals, slot, seg, num_slots,
                                            num_segments)
    name = "slot_outer_segment_sum"
    _cuda.require(vals.device.type == "cuda",
                  f"{name}: no kernel for device {vals.device}")
    _cuda.require_cuda(name, vals, slot, seg)
    _cuda.require(vals.dim() == 3 and vals.shape[2] == SLOT_CHANNELS
                  and vals.dtype == torch.float32,
                  f"{name}: vals must be float32 [B, P, {SLOT_CHANNELS}], got "
                  f"{vals.dtype} {tuple(vals.shape)}")
    _cuda.require(slot.dtype == seg.dtype == torch.int32
                  and slot.shape == seg.shape == vals.shape[:2],
                  f"{name}: slot and seg must be int32 "
                  f"{tuple(vals.shape[:2])}")
    _cuda.require(num_slots in KERNEL_SLOTS and num_segments > 0
                  and min(vals.shape) > 0,
                  f"{name}: the kernel takes {KERNEL_SLOTS} slots, got "
                  f"{num_slots} (and {num_segments} segments)")
    B, P, cv = vals.shape
    out = torch.empty((B, num_segments, num_slots, cv), dtype=torch.float32,
                      device=vals.device)
    code = _cuda.library().geomae_slot_outer_segment_sum(
        vals.data_ptr(), slot.data_ptr(), seg.data_ptr(), out.data_ptr(), B,
        P, num_segments, num_slots, _cuda.stream(vals))
    slot_outer_segment_sum.launches += 1
    _cuda.check(code, name)
    return out


slot_outer_segment_sum.launches = 0


def expand_rows(feats: torch.Tensor, key: torch.Tensor,
                n_cells: int) -> torch.Tensor:
    """K4: feats [B, V, C] f32, key [B, V] int32 ascending and unique
    below n_cells, n_cells on a suffix -> f32 [B, n_cells + 1, C] with
    ``out[b, key[b, r]] = feats[b, r]`` and 0 elsewhere (row n_cells
    included)."""
    if feats.device.type == "cpu":
        return expand_rows_plain(feats, key, n_cells)
    name = "expand_rows"
    _cuda.require(feats.device.type == "cuda",
                  f"{name}: no kernel for device {feats.device}")
    _cuda.require_cuda(name, feats, key)
    _cuda.require(feats.dim() == 3 and feats.dtype == torch.float32
                  and min(feats.shape) > 0,
                  f"{name}: feats must be float32 [B, V, C], got "
                  f"{feats.dtype} {tuple(feats.shape)}")
    _cuda.require(key.dtype == torch.int32 and key.shape == feats.shape[:2],
                  f"{name}: key must be int32 {tuple(feats.shape[:2])}")
    B, V, C = feats.shape
    _cuda.require(0 < n_cells and B * (n_cells + 1) * C < 2 ** 31,
                  f"{name}: {n_cells} cells of {C} channels")
    out = torch.empty((B, n_cells + 1, C), dtype=torch.float32,
                      device=feats.device)
    code = _cuda.library().geomae_expand_rows(
        feats.data_ptr(), key.data_ptr(), out.data_ptr(), B, V, C, n_cells,
        _cuda.stream(feats))
    expand_rows.launches += 1
    _cuda.check(code, name)
    return out


expand_rows.launches = 0
