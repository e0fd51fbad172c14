"""The PointNet++ op family on dense point sets.

Port of ``geomae_tpu/ops/pointnet_ops.py``, mmdet3d's CUDA extensions
``knn``, ``ball_query``, ``furthest_point_sample``, ``gather_points``,
``group_points`` and ``interpolate`` (``mmdet3d/ops/``).  None is on the
GeoMAE path; they complete the op inventory of the reference zoo.

Everything is a dense batched computation over ``[B, N, 3]`` point sets
with optional validity masks: pairwise squared distances are one batched
product, ``|c|^2 + |x|^2 - 2 c.x``; selection is ``topk`` or a stable
sort; furthest point sampling is a loop over the samples, vectorised over
the batch.  Gathers are ``torch.gather``, and autograd gives the
backwards that the reference writes in CUDA.  As in the JAX package no
hand-written kernel backs them: the JAX functions reach no Pallas kernel.

Index and padding rules, the CUDA kernels':

* ``ball_query`` fills unused sample slots with the first in-ball index
  (slot 0's) and leaves a row with no in-ball point at index 0;
* ``furthest_point_sample`` always selects index 0 first and breaks
  argmax ties at the lowest index;
* ``knn`` and ``three_nn`` return neighbours by ascending distance.
"""
from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e10


def square_distance(src: torch.Tensor, dst: torch.Tensor,
                    src_valid: Optional[torch.Tensor] = None,
                    dst_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N, M] f32 squared L2 distances of src [B, N, 3] to dst [B, M,
    3]; invalid rows and columns read ``1e10``."""
    src, dst = src.float(), dst.float()
    cross = torch.einsum("bnc,bmc->bnm", src, dst)
    s2 = (src * src).sum(-1)[:, :, None]
    d2 = (dst * dst).sum(-1)[:, None, :]
    dist = torch.clamp(s2 + d2 - 2.0 * cross, min=0.0)
    if dst_valid is not None:
        dist = torch.where(dst_valid[:, None, :], dist, _BIG)
    if src_valid is not None:
        dist = torch.where(src_valid[:, :, None], dist, _BIG)
    return dist


def knn(k: int, xyz: torch.Tensor, center_xyz: Optional[torch.Tensor] = None,
        xyz_valid: Optional[torch.Tensor] = None):
    """The ``k`` nearest of ``xyz`` [B, N, 3] to each centre [B, S, 3]
    (default ``xyz``): (L2 distances [B, S, k] ascending, int64 indices
    into N)."""
    if center_xyz is None:
        center_xyz = xyz
    d2 = square_distance(center_xyz, xyz, dst_valid=xyz_valid)
    neg, idx = torch.topk(-d2, k, dim=-1)
    return torch.sqrt(torch.clamp(-neg, min=0.0)), idx


def ball_query(min_radius: float, max_radius: float, sample_num: int,
               xyz: torch.Tensor, center_xyz: torch.Tensor,
               xyz_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices [B, S, sample_num] int32 of up to ``sample_num`` points of
    ``xyz`` in each centre's shell, in ascending index order; a
    ``min_radius`` of 0 admits the centre itself, otherwise the shell is
    [min, max)."""
    d2 = square_distance(center_xyz, xyz, dst_valid=xyz_valid)
    ok = d2 < max_radius * max_radius
    if min_radius > 0:
        ok &= d2 >= min_radius * min_radius
    # hits (key 0) before misses (1), index order kept inside each
    order = torch.argsort((~ok).to(torch.uint8), dim=-1, stable=True)
    idx = order[..., :sample_num].to(torch.int32)
    cnt = ok.sum(-1, dtype=torch.int32)                     # [B, S]
    slot = torch.arange(sample_num, dtype=torch.int32, device=idx.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    return torch.where(cnt[..., None] > 0, idx, 0)


def _fps(dist_to, b: int, n: int, num_points: int, device,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Furthest point sampling from ``dist_to(last)`` [B, N], the
    distances of every point to the last selected one."""
    temp = torch.full((b, n), _BIG, dtype=torch.float32, device=device)
    if valid is not None:
        temp = torch.where(valid, temp, -1.0)
    out = torch.zeros((b, num_points), dtype=torch.int32, device=device)
    last = torch.zeros(b, dtype=torch.long, device=device)
    for i in range(1, num_points):
        temp = torch.minimum(temp, dist_to(last))
        if valid is not None:
            temp = torch.where(valid, temp, -1.0)
        last = torch.argmax(temp, -1)            # the first of any ties
        out[:, i] = last.to(torch.int32)
    return out


def furthest_point_sample(points_xyz: torch.Tensor, num_points: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Iterative furthest point sampling of [B, N, 3]: int32 [B,
    num_points], index 0 first; invalid points are never selected."""
    xyz = points_xyz.float()
    b, n = xyz.shape[:2]

    def dist_to(last):
        p = torch.gather(xyz, 1, last[:, None, None].expand(b, 1, 3))
        return ((xyz - p) ** 2).sum(-1)
    return _fps(dist_to, b, n, num_points, xyz.device, valid)


def furthest_point_sample_with_dist(points_dist: torch.Tensor,
                                    num_points: int) -> torch.Tensor:
    """Furthest point sampling over a [B, N, N] distance matrix."""
    b, n = points_dist.shape[:2]

    def dist_to(last):
        return torch.gather(points_dist, 1,
                            last[:, None, None].expand(b, 1, n))[:, 0]
    return _fps(dist_to, b, n, num_points, points_dist.device)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, C, N], [B, S] -> [B, C, S]."""
    b, c, _ = features.shape
    return torch.gather(features, 2, idx.long()[:, None, :].expand(
        b, c, idx.shape[1]))


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, C, N], [B, S, K] -> [B, C, S, K]."""
    b, c, _ = features.shape
    s, k = idx.shape[1:]
    return gather_points(features, idx.reshape(b, s * k)).reshape(b, c, s, k)


def three_nn(target: torch.Tensor, source: torch.Tensor,
             source_valid: Optional[torch.Tensor] = None):
    """The 3 nearest ``source`` points of each ``target`` point: (L2
    distances [B, N, 3] ascending, indices)."""
    return knn(3, source, target, xyz_valid=source_valid)


def three_interpolate(features: torch.Tensor, indices: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 neighbours' features: features [B, C, M],
    indices and weight [B, N, 3] -> [B, C, N]."""
    return (group_points(features, indices) * weight[:, None]).sum(-1)


def query_and_group(points_xyz: torch.Tensor, center_xyz: torch.Tensor,
                    features: Optional[torch.Tensor] = None, *,
                    max_radius: Optional[float] = None, sample_num: int = 16,
                    min_radius: float = 0.0, use_xyz: bool = True,
                    normalize_xyz: bool = False,
                    xyz_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``QueryAndGroup``: ball-query (kNN without ``max_radius``)
    neighbourhoods of the centres [B, S, 3] with their xyz offsets:
    [B, 3 (+ C), S, sample_num], the offsets first when ``use_xyz``."""
    if max_radius is None:
        _, idx = knn(sample_num, points_xyz, center_xyz, xyz_valid=xyz_valid)
    else:
        idx = ball_query(min_radius, max_radius, sample_num, points_xyz,
                         center_xyz, xyz_valid=xyz_valid)
    grouped_xyz = group_points(points_xyz.transpose(1, 2), idx)
    grouped_xyz = grouped_xyz - center_xyz.transpose(1, 2)[..., None]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / max_radius
    if features is not None:
        grouped = group_points(features, idx)
        return torch.cat([grouped_xyz, grouped], 1) if use_xyz else grouped
    if not use_xyz:
        raise ValueError("no features to group and use_xyz is False")
    return grouped_xyz


def group_all(points_xyz: torch.Tensor,
              features: Optional[torch.Tensor] = None,
              use_xyz: bool = True) -> torch.Tensor:
    """``GroupAll``: the whole set as one group, [B, 3 (+ C), 1, N]."""
    grouped_xyz = points_xyz.transpose(1, 2)[:, :, None, :]
    if features is not None:
        grouped = features[:, :, None, :]
        return torch.cat([grouped_xyz, grouped], 1) if use_xyz else grouped
    return grouped_xyz
