"""Fixed-capacity dynamic voxelization by one sort.

Port of ``geomae_tpu/ops/voxelize.py`` (``low_voxel_coords``,
``sub_voxel_slots``, ``build_scene``, ``scene_from_arrays``,
``hard_voxelize``, ``lookup_rows``, ``neighbor_rows``).  Points are
sorted ONCE by ``pillar_key * num_slots_low + slot_sort``, so every later
segment op sees ascending pillar ids; pillar rows are the ascending
unique pillar keys, ranked densely, and a point of a pillar past the row
capacity (or an invalid point) carries the sentinel id ``v_cap``, always
as a suffix.  ``scene_from_arrays`` takes a scene the loader sorted on
the host (``data/native_prep.build_scene_host``: a radix sort, stable
too, so it equals this sort's scene).

Batched over a leading axis ([B, P, D]) instead of the JAX ``vmap``.  The
sort here is stable; the JAX sort is not inside equal keys, so the two
agree on every table field and on the points per (pillar, slot) group,
not on the order inside a group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import VoxelConfig

INT32_MAX = 2 ** 31 - 1


class VoxelTable(NamedTuple):
    """Fixed-capacity pillar table, batched.

    coords int32 [B, V, 2] (y, x), 0 where invalid; valid bool [B, V];
    num_voxels int32 [B] (may exceed V: the overflow's points are
    dropped); point2voxel int32 [B, P], ascending, ``V`` for invalid or
    overflowed points (a suffix)."""

    coords: torch.Tensor
    valid: torch.Tensor
    num_voxels: torch.Tensor
    point2voxel: torch.Tensor


class Scene(NamedTuple):
    """Points in canonical (pillar, slot_sort) order, batched; fields as
    in ``geomae_tpu.ops.voxelize.Scene``."""

    points: torch.Tensor
    valid: torch.Tensor
    table: VoxelTable
    slot_low: torch.Tensor
    slot_med: torch.Tensor
    slot_sort: torch.Tensor


def low_voxel_coords(points_xyz: torch.Tensor,
                     cfg: VoxelConfig) -> torch.Tensor:
    """int32 (z, y, x) coords at the finest sub-voxel grid, clamped."""
    r = cfg.point_cloud_range
    vx, vy, vz = cfg.voxel_size
    rz, ry, rx = cfg.sub_voxel_ratio_low
    ny, nx = cfg.grid_size
    dev = points_xyz.device
    sizes = torch.tensor([vz / rz, vy / ry, vx / rx], dtype=torch.float32,
                         device=dev)
    origin = torch.tensor([r[2], r[1], r[0]], dtype=torch.float32,
                          device=dev)
    zyx = points_xyz.flip(-1).to(torch.float32)
    c = torch.floor((zyx - origin) / sizes).to(torch.int32)
    hi = torch.tensor([rz - 1, ny * ry - 1, nx * rx - 1], dtype=torch.int32,
                      device=dev)
    return torch.minimum(c.clamp_min(0), hi)


def sub_voxel_slots(low: torch.Tensor, cfg: VoxelConfig):
    """(slot_low, slot_med, slot_sort) int32 from low coords [..., 3]."""
    lz, ly, lx = low[..., 0], low[..., 1], low[..., 2]
    rz, ry, rx = cfg.sub_voxel_ratio_low
    mz, my, mx = cfg.sub_voxel_ratio_med
    slot_low = (lz % rz) * (ry * rx) + (ly % ry) * rx + (lx % rx)
    fz, fy, fx = rz // mz, ry // my, rx // mx
    cz, cy, cx = lz // fz, ly // fy, lx // fx
    slot_med = (cz % mz) * (my * mx) + (cy % my) * mx + (cx % mx)
    intra = ((lz % rz) % fz) * (fy * fx) + ((ly % ry) % fy) * fx \
        + ((lx % rx) % fx)
    slot_sort = slot_med * (fz * fy * fx) + intra
    return (slot_low.to(torch.int32), slot_med.to(torch.int32),
            slot_sort.to(torch.int32))


def build_scene_batch(points: torch.Tensor, point_valid: torch.Tensor,
                      cfg: VoxelConfig, v_cap: int) -> Scene:
    """points [B, P, D] (x, y, z first; range-filtered and padded),
    point_valid bool [B, P] -> the sorted Scene with its pillar table."""
    B, P, D = points.shape
    dev = points.device
    ny, nx = cfg.grid_size
    rz, ry, rx = cfg.sub_voxel_ratio_low
    s_low = rz * ry * rx
    low = low_voxel_coords(points[..., :3], cfg)
    _, _, slot_sort = sub_voxel_slots(low, cfg)
    pillar_key = (low[..., 1] // ry) * nx + (low[..., 2] // rx)
    key = torch.where(point_valid, pillar_key * s_low + slot_sort, INT32_MAX)

    key_s, order = torch.sort(key, dim=1, stable=True)
    valid_s = key_s != INT32_MAX
    pk_s = torch.where(valid_s, key_s // s_low, INT32_MAX)
    points_s = torch.gather(points, 1, order[..., None].expand(B, P, D))
    slot_low_s, slot_med_s, slot_sort_s = sub_voxel_slots(
        low_voxel_coords(points_s[..., :3], cfg), cfg)

    first = torch.ones_like(valid_s)
    first[:, 1:] = pk_s[:, 1:] != pk_s[:, :-1]
    first &= valid_s
    rank = torch.cumsum(first, 1, dtype=torch.int32) - 1
    num_voxels = first.sum(1, dtype=torch.int32)
    in_cap = valid_s & (rank >= 0) & (rank < v_cap)
    p2v = torch.where(in_cap, rank, v_cap).to(torch.int32)

    # row r <- the pillar key of rank r (first occurrences ascend, so this
    # is the JAX value sort of the masked keys); column v_cap is a trash
    # slot for every other point
    dst = torch.where(first & (rank < v_cap), rank, v_cap).long()
    key_rows = torch.full((B, v_cap + 1), INT32_MAX, dtype=torch.int32,
                          device=dev)
    key_rows.scatter_(1, dst, pk_s.to(torch.int32))
    tvalid = (torch.arange(v_cap, device=dev)[None, :]
              < num_voxels[:, None])
    safe = torch.where(tvalid, key_rows[:, :v_cap], 0)
    coords = torch.stack([safe // nx, safe % nx], -1).to(torch.int32)

    table = VoxelTable(coords=coords, valid=tvalid, num_voxels=num_voxels,
                       point2voxel=p2v)
    return Scene(points=points_s, valid=valid_s, table=table,
                 slot_low=slot_low_s, slot_med=slot_med_s,
                 slot_sort=slot_sort_s)


def scene_from_arrays(batch) -> Scene:
    """The Scene of a batch that the loader sorted on the host
    (``data.native_prep.build_scene_host``, stacked): its ``points``,
    ``point_valid``, ``slot_low``, ``slot_med``, ``slot_sort``, ``p2v``,
    ``coords``, ``table_valid`` and ``num_voxels`` tensors."""
    table = VoxelTable(coords=batch["coords"], valid=batch["table_valid"],
                       num_voxels=batch["num_voxels"],
                       point2voxel=batch["p2v"])
    return Scene(points=batch["points"], valid=batch["point_valid"],
                 table=table, slot_low=batch["slot_low"],
                 slot_med=batch["slot_med"], slot_sort=batch["slot_sort"])


def hard_voxelize(scene: Scene, max_points: int):
    """Dense per-voxel point buffers from a sorted scene (the CUDA
    ``hard_voxelize`` of mmdet3d, ``ops/voxel/src/voxelization.h``).

    Points are pillar-sorted, so a point's rank in its voxel is its
    position minus its segment's start (a running max of the starts).
    Invalid and sentinel points and the points past ``max_points`` in a
    voxel fill no slot.  Returns (voxels [B, V, max_points, D], zero where
    no point was written; num_points int32 [B, V], capped at
    ``max_points``)."""
    B, P, D = scene.points.shape
    v_cap = scene.table.valid.shape[-1]
    p2v = scene.table.point2voxel.long()
    pos = torch.arange(P, device=p2v.device).expand(B, P)
    first = torch.ones_like(scene.valid)
    first[:, 1:] = p2v[:, 1:] != p2v[:, :-1]
    seg_start = torch.cummax(torch.where(first, pos, 0), 1).values
    rank = pos - seg_start
    ok = scene.valid & (p2v < v_cap) & (rank < max_points)
    # slot v_cap * max_points is a trash row for every point that fills none
    slot = torch.where(ok, p2v * max_points + rank, v_cap * max_points)
    voxels = scene.points.new_zeros((B, v_cap * max_points + 1, D))
    voxels.scatter_(1, slot[..., None].expand(B, P, D), scene.points)
    voxels = voxels[:, :-1].reshape(B, v_cap, max_points, D)
    counts = torch.zeros((B, v_cap + 1), dtype=torch.int32,
                         device=p2v.device)
    counts.scatter_add_(1, torch.where(ok, p2v, v_cap), ok.to(torch.int32))
    return voxels, counts[:, :v_cap].clamp_max(max_points)


def lookup_rows(coords: torch.Tensor, valid: torch.Tensor, ny: int, nx: int,
                query_keys: torch.Tensor,
                query_ok: torch.Tensor) -> torch.Tensor:
    """Pillar rows of linear (y, x) keys by binary search, batched.

    coords int32 [B, V, 2] and valid [B, V] of a key-sorted table (the
    invalid rows a suffix, keyed INT32_MAX); query_keys and query_ok [B,
    ...].  Returns int32 rows shaped like ``query_keys``; a miss or a
    query that is not ok gives ``V``."""
    B, v_cap = valid.shape
    key = torch.where(valid, coords[..., 0] * nx + coords[..., 1],
                      INT32_MAX).to(torch.int32).contiguous()
    q = query_keys.reshape(B, -1).to(torch.int32).contiguous()
    pos = torch.searchsorted(key, q, side="left").clamp_max(v_cap - 1)
    hit = (torch.gather(key, 1, pos) == q) & query_ok.reshape(B, -1)
    return torch.where(hit, pos, v_cap).to(torch.int32).reshape(
        query_keys.shape)


def neighbor_rows(coords: torch.Tensor, valid: torch.Tensor, ny: int,
                  nx: int, v_cap: int) -> torch.Tensor:
    """The 3x3 neighbourhood's pillar rows, int32 [B, V, 9], ``v_cap``
    where a neighbour is missing; taps in row-major (dy, dx) order over
    {-1, 0, 1}^2, a [1, 3, 3] submanifold conv's."""
    y, x = coords[..., 0], coords[..., 1]
    keys, oks = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yy, xx = y + dy, x + dx
            keys.append(yy.clamp(0, ny - 1) * nx + xx.clamp(0, nx - 1))
            oks.append(valid & (yy >= 0) & (yy < ny) & (xx >= 0)
                       & (xx < nx))
    return lookup_rows(coords, valid, ny, nx, torch.stack(keys, -1),
                       torch.stack(oks, -1))
