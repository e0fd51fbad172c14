"""Shifted-window band layouts and the in-window positional embedding.

Port of ``geomae_tpu/ops/windows.py`` (``window_ids``, ``make_layouts`` in
its band layout, ``positional_embedding``).  Per shift the pillars sort by
window id, so each window is a contiguous run of tokens and attention is
exact per window (``ops/attention.py``).  Batched [B, V].
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import SSTConfig, VoxelConfig

INT32_MAX = 2 ** 31 - 1


class WindowLayout(NamedTuple):
    """One shift's layout, batched.

    perm int64 [B, V]: table row at each sorted position; inv_perm int64
    [B, V]: sorted position of each row; win_id int32 [B, V]: window id
    per sorted position (INT32_MAX for invalid rows, which sort last);
    coors_in_win int32 [B, V, 2]: (x, y) inside the window, in row order.
    """

    perm: torch.Tensor
    inv_perm: torch.Tensor
    win_id: torch.Tensor
    coors_in_win: torch.Tensor


def window_ids(coords: torch.Tensor, valid: torch.Tensor,
               shift: Tuple[int, int], sst: SSTConfig, voxel: VoxelConfig):
    """(win_id int32 [B, V], coors_in_win int32 [B, V, 2]) for one shift;
    coordinates shift by ``window - shift`` when the shift is non-zero and
    ids hash x-major, ``wx * max_num_win_y + wy``."""
    win_x, win_y = sst.window_shape
    ny, _ = voxel.grid_size
    shift_x, shift_y = shift
    max_num_win_y = int(math.ceil(ny / win_y)) + 1
    x = coords[..., 1] + (win_x - shift_x if shift_x > 0 else 0)
    y = coords[..., 0] + (win_y - shift_y if shift_y > 0 else 0)
    win = (x // win_x) * max_num_win_y + (y // win_y)
    win = torch.where(valid, win, INT32_MAX).to(torch.int32)
    ciw = torch.stack([x % win_x, y % win_y], -1).to(torch.int32)
    return win, ciw


def make_layouts(coords: torch.Tensor, valid: torch.Tensor, sst: SSTConfig,
                 voxel: VoxelConfig) -> Tuple[WindowLayout, ...]:
    """Band layouts for every shift of ``sst``: coords [B, V, 2], valid
    [B, V]."""
    out = []
    for shift in sst.shifts:
        win, ciw = window_ids(coords, valid, shift, sst, voxel)
        win_sorted, perm = torch.sort(win, dim=-1, stable=True)
        iota = torch.arange(perm.shape[-1], device=perm.device)
        inv = torch.empty_like(perm).scatter_(-1, perm, iota.expand_as(perm))
        out.append(WindowLayout(perm=perm, inv_perm=inv, win_id=win_sorted,
                                coors_in_win=ciw))
    return tuple(out)


def positional_embedding(coors_in_win: torch.Tensor,
                         sst: SSTConfig) -> torch.Tensor:
    """Sinusoidal in-window embedding [..., d_model] float32 from (x, y)
    in-window coords: offsets from the window centre, interleaved sin/cos
    per axis, x then y."""
    win_x, win_y = sst.window_shape
    x = coors_in_win[..., 0].to(torch.float32) - win_x / 2
    y = coors_in_win[..., 1].to(torch.float32) - win_y / 2
    if sst.normalize_pos:
        x = x / win_x * 2 * 3.1415
        y = y / win_y * 2 * 3.1415
    pos_length = sst.d_model // 2
    i = torch.arange(pos_length, dtype=torch.float32, device=x.device)
    inv_freq = torch.pow(
        torch.tensor(sst.pos_temperature, dtype=torch.float32,
                     device=x.device),
        2 * torch.div(i, 2, rounding_mode="floor") / pos_length)
    even = (torch.arange(pos_length, device=x.device) % 2) == 0

    def mix(e):
        return torch.where(even, torch.sin(e), torch.cos(e))

    return torch.cat([mix(x[..., None] / inv_freq),
                      mix(y[..., None] / inv_freq)], -1)
