"""Synthetic LiDAR-like frames and labelled scenes (numpy), for smoke
runs, training runs from a seed, and tests.

The point distribution of ``bench.py:realistic_batch`` (which imports
JAX): 60 Gaussian object clusters plus a thin ground layer, clipped to
the point-cloud range, with intensity and sweep-time channels.
``clustered_scene`` adds a ground-truth box at each cluster centre.
"""
from __future__ import annotations

import numpy as np

from .config import FinetuneConfig, VoxelConfig


def _clusters(rng: np.random.Generator, voxel: VoxelConfig, max_points: int,
              n_clusters: int):
    """(frame [n, 5], cluster centres [n_clusters, 3])."""
    r = voxel.point_cloud_range
    n = int(rng.integers(int(max_points * 0.7), max_points))
    centers = rng.uniform([r[0], r[1], -2.0], [r[3], r[4], 0.5],
                          (n_clusters, 3))
    k = n // (n_clusters + 1)
    chunks = [rng.normal(c, [1.5, 1.5, 0.6], (k, 3)) for c in centers]
    ground = rng.uniform([r[0], r[1], -1.9], [r[3], r[4], -1.7],
                         (n - k * n_clusters, 3))
    xyz = np.clip(np.concatenate(chunks + [ground], 0), [r[0], r[1], r[2]],
                  [r[3] - 1e-3, r[4] - 1e-3, r[5] - 1e-3])
    pts = np.empty((n, 5), np.float32)
    pts[:, :3] = xyz
    pts[:, 3] = rng.uniform(0, 1, n)
    pts[:, 4] = rng.uniform(0, 0.45, n)
    return pts, centers


def clustered_frame(rng: np.random.Generator, voxel: VoxelConfig,
                    max_points: int, n_clusters: int = 60) -> np.ndarray:
    """One raw frame [n, 5] (x y z intensity dt), n in [0.7, 1) x
    ``max_points``, every point inside the range."""
    return _clusters(rng, voxel, max_points, n_clusters)[0]


def clustered_scene(rng: np.random.Generator, cfg: FinetuneConfig,
                    n_clusters: int = 60):
    """A labelled frame: (points [n, 5], gt_boxes [n_clusters, 9],
    gt_labels [n_clusters]).  The points are ``clustered_frame``'s; each
    cluster centre carries a box of a random anchor type, with that type's
    anchor size and bottom height, one of the anchor rotations plus up to
    0.1 rad, and a small velocity, so that the anchor head finds positive
    anchors at full width."""
    pts, centers = _clusters(rng, cfg.voxel, cfg.caps.max_points,
                             n_clusters)
    head = cfg.head
    kind = rng.integers(0, len(head.anchor_sizes), n_clusters)
    sizes = np.asarray(head.anchor_sizes, np.float32)[kind]
    z = np.asarray([rg[2] for rg in head.anchor_ranges], np.float32)[kind]
    yaw = (np.asarray(head.rotations, np.float32)[
        rng.integers(0, len(head.rotations), n_clusters)]
        + rng.uniform(-0.1, 0.1, n_clusters))
    boxes = np.concatenate([
        centers[:, :2], z[:, None], sizes, yaw[:, None],
        rng.normal(0, 1, (n_clusters, 2))], -1).astype(np.float32)
    return pts, boxes, kind.astype(np.int32)
