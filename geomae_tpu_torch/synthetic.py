"""Synthetic LiDAR-like frames (numpy), for smoke runs and tests.

The point distribution of ``bench.py:realistic_batch`` (which imports
JAX): 60 Gaussian object clusters plus a thin ground layer, clipped to
the point-cloud range, with intensity and sweep-time channels.
"""
from __future__ import annotations

import numpy as np

from geomae_tpu.config import VoxelConfig


def clustered_frame(rng: np.random.Generator, voxel: VoxelConfig,
                    max_points: int, n_clusters: int = 60) -> np.ndarray:
    """One raw frame [n, 5] (x y z intensity dt), n in [0.7, 1) x
    ``max_points``, every point inside the range."""
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
    return pts
