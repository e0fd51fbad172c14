"""Aligned 3D anchors (numpy).

The same functions as ``geomae_tpu/models/anchors.py`` (``grid_anchors``,
``num_anchors_per_cell``), kept here because importing
``geomae_tpu.models`` imports JAX.  Anchor centres sit at cell centres
of the feature map, one (size x rotation) pair per anchor type per cell,
with zero velocities appended.
"""
from __future__ import annotations

import numpy as np

from ..config import AnchorHeadConfig, FinetuneConfig


def grid_anchors(cfg: AnchorHeadConfig, featmap_size) -> np.ndarray:
    """float32 [ny * nx * types * rots, 9] (x, y, z, w, l, h, yaw, vx, vy),
    ordered (y, x, type, rot) row-major."""
    ny, nx = featmap_size
    rows = []
    for rng, size in zip(cfg.anchor_ranges, cfg.anchor_sizes):
        x_centers = np.linspace(rng[0], rng[3], nx, endpoint=False,
                                dtype=np.float32)
        y_centers = np.linspace(rng[1], rng[4], ny, endpoint=False,
                                dtype=np.float32)
        x_centers = x_centers + (rng[3] - rng[0]) / nx / 2
        y_centers = y_centers + (rng[4] - rng[1]) / ny / 2
        yy, xx = np.meshgrid(y_centers, x_centers, indexing="ij")
        per_cell = []
        for rot in cfg.rotations:
            per_cell.append(np.stack([
                xx, yy, np.full_like(xx, rng[2]),
                np.full_like(xx, size[0]), np.full_like(xx, size[1]),
                np.full_like(xx, size[2]), np.full_like(xx, rot),
                np.zeros_like(xx), np.zeros_like(xx)], axis=-1))
        rows.append(np.stack(per_cell, axis=2))      # [ny, nx, R, 9]
    return np.stack(rows, axis=2).reshape(-1, 9).astype(np.float32)


def num_anchors_per_cell(cfg: AnchorHeadConfig) -> int:
    return len(cfg.anchor_sizes) * len(cfg.rotations)


def head_featmap_size(cfg: FinetuneConfig):
    """(ny, nx) of the head's feature map: the FPN returns to stage 0."""
    ny, nx = cfg.voxel.grid_size
    s = cfg.second.layer_strides[0]
    return ny // s, nx // s
