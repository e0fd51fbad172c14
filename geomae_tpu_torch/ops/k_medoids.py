"""Batched k-medoids clustering.

Port of ``geomae_tpu/ops/k_medoids.py`` (mmdet3d's ``ops/sst/
k_medoids.py``, the experimental SRA block's clustering): the member sums
of every cluster come from one batched product ``dist @ one_hot
(assignment)``, with the same rules as the reference:

* initial medoids: the ``num_clusters`` smallest column sums of the
  row-normalised distance matrix;
* assignment: the nearest current medoid, the first of any ties;
* update: the in-cluster point of least total distance to its cluster,
  all-zero sums pushed to 1e6;
* ``num_clusters >= num_samples`` gives ``[0..N)`` then ``padding_idx``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def select_initial_medoids(dist: torch.Tensor,
                           num_clusters: int) -> torch.Tensor:
    """[B, N, N] -> int32 [B, K], the K smallest normalised scores."""
    norm = dist / (dist.sum(-1, keepdim=True) + 1e-8)
    _, idx = torch.topk(-norm.sum(1), num_clusters, dim=-1)
    return idx.to(torch.int32)


def assign_samples_to_medoids(dist: torch.Tensor, medoids: torch.Tensor):
    """(assignment int32 [B, N], the total of the least distances [B])."""
    b, n, _ = dist.shape
    d2m = torch.gather(dist, 2, medoids.long()[:, None, :].expand(
        b, n, medoids.shape[1]))
    return torch.argmin(d2m, 2).to(torch.int32), d2m.amin(2).sum(-1)


def update_medoids(dist: torch.Tensor, assignment: torch.Tensor,
                   num_clusters: int) -> torch.Tensor:
    """Per cluster the in-cluster point minimising its total distance to
    the cluster, int32 [B, K]."""
    a = F.one_hot(assignment.long(), num_clusters).to(dist.dtype)
    sums = torch.einsum("bjs,bsk->bjk", dist, a)            # [B, N, K]
    sums = torch.where(a > 0, sums, 0.0)
    sums = torch.where(sums == 0, 1e6, sums)
    return torch.argmin(sums, 1).to(torch.int32)


def k_medoids(dist: torch.Tensor, num_clusters: int, max_iter: int = 3,
              padding_idx: int = 0,
              init_medoids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K-medoids over [B, N, N] distance matrices: int32 [B, K] medoid
    indices after ``max_iter`` update and assignment rounds
    (``init_medoids`` [B, K] overrides the initial choice)."""
    b, n, _ = dist.shape
    if num_clusters >= n:
        out = torch.full((b, num_clusters), padding_idx, dtype=torch.int32,
                         device=dist.device)
        out[:, :n] = torch.arange(n, dtype=torch.int32, device=dist.device)
        return out
    medoids = (init_medoids.to(torch.int32) if init_medoids is not None
               else select_initial_medoids(dist, num_clusters))
    assignment, _ = assign_samples_to_medoids(dist, medoids)
    for _ in range(max_iter):
        medoids = update_medoids(dist, assignment, num_clusters)
        assignment, _ = assign_samples_to_medoids(dist, medoids)
    return medoids
