"""Synthetic labelled LiDAR scenes (numpy), the data of ``--synthetic``
training runs and of tests, and info files on disk.

The port's own copy of ``geomae_tpu/data/synthetic.py``
(``synthetic_scene``, ``write_synthetic_infos``): point clusters inside
boxes over a ground plane, with box annotations consistent with the
clusters, and the same scenes written as nuScenes-schema ``.bin`` files
with an info pickle, byte for byte what the JAX package writes.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np


def synthetic_scene(rng: np.random.Generator, pc_range, n_points: int,
                    n_objects: int = 12):
    """Returns (points [N, 5], boxes [M, 9], labels [M])."""
    lo = np.array([pc_range[0], pc_range[1], -2.0])
    hi = np.array([pc_range[3], pc_range[4], 0.5])
    boxes = []
    labels = []
    chunks = []
    per_obj = n_points // (n_objects * 2)
    for _ in range(n_objects):
        ctr = rng.uniform(lo, hi)
        dims = rng.uniform([1.5, 1.5, 1.0], [5.0, 2.5, 2.5])
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        local = rng.uniform(-0.5, 0.5, (per_obj, 3)) * dims
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        chunks.append(local @ R.T + ctr)
        boxes.append([*ctr, *dims, yaw, 0.0, 0.0])
        labels.append(rng.integers(0, 10))
    n_ground = n_points - per_obj * n_objects
    ground = np.stack([
        rng.uniform(pc_range[0], pc_range[3], n_ground),
        rng.uniform(pc_range[1], pc_range[4], n_ground),
        rng.normal(-1.8, 0.05, n_ground)], -1)
    xyz = np.concatenate(chunks + [ground]).astype(np.float32)
    eps = 1e-3
    xyz = np.clip(xyz, [pc_range[0], pc_range[1], pc_range[2]],
                  [pc_range[3] - eps, pc_range[4] - eps, pc_range[5] - eps])
    extra = np.stack([rng.uniform(0, 1, n_points),
                      rng.uniform(0, 0.45, n_points)], -1).astype(np.float32)
    pts = np.concatenate([xyz, extra], -1)
    return pts, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


def write_synthetic_infos(tmpdir: str, n_frames: int = 3,
                          n_points: int = 4000,
                          n_sweeps: int = 2) -> str:
    """Write .bin files + an info pkl in the nuScenes schema; returns the
    pkl path.  Every box is a car."""
    rng = np.random.default_rng(0)
    infos: List[Dict] = []
    os.makedirs(f"{tmpdir}/sweeps", exist_ok=True)
    for i in range(n_frames):
        pts, boxes, labels = synthetic_scene(
            rng, (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), n_points)
        raw = np.concatenate([pts[:, :4],
                              np.zeros((len(pts), 1), np.float32)], -1)
        path = f"{tmpdir}/frame_{i}.bin"
        raw.astype(np.float32).tofile(path)
        sweeps = []
        for j in range(n_sweeps):
            spts, _, _ = synthetic_scene(
                rng, (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), n_points // 2)
            sraw = np.concatenate([spts[:, :4],
                                   np.zeros((len(spts), 1), np.float32)], -1)
            spath = f"{tmpdir}/sweeps/frame_{i}_{j}.bin"
            sraw.astype(np.float32).tofile(spath)
            sweeps.append(dict(
                data_path=spath,
                sensor2lidar_rotation=np.eye(3),
                sensor2lidar_translation=np.zeros(3),
                timestamp=(1_000_000 * i - 100_000 * (j + 1)),
            ))
        infos.append(dict(
            lidar_path=path, token=f"tok{i}", timestamp=1_000_000 * i,
            sweeps=sweeps, gt_boxes=boxes[:, :7],
            gt_velocity=boxes[:, 7:9],
            gt_names=np.array(["car"] * len(boxes)),
            valid_flag=np.ones(len(boxes), bool),
            num_lidar_pts=np.full(len(boxes), 10),
        ))
    pkl_path = f"{tmpdir}/infos.pkl"
    with open(pkl_path, "wb") as f:
        pickle.dump(dict(infos=infos, metadata=dict(version="synthetic")), f)
    return pkl_path


class SyntheticSSL:
    """``n`` unlabelled scenes for the pretrain task, each from the seed
    ``seed + idx``: ``dict(points [P, 5], point_valid [P])`` padded to the
    point cap."""

    def __init__(self, cfg, n: int = 64):
        self.cfg, self.n = cfg, n

    def __len__(self) -> int:
        return self.n

    def scene(self, idx: int, seed):
        rng = np.random.default_rng((seed or 0) + idx)
        return synthetic_scene(rng, self.cfg.voxel.point_cloud_range,
                               min(self.cfg.caps.max_points, 16384))

    def __getitem__(self, idx: int, seed=None) -> dict:
        from .transforms import pad_points
        p, v = pad_points(self.scene(idx, seed)[0], self.cfg.caps.max_points)
        return dict(points=p, point_valid=v)


class SyntheticDet(SyntheticSSL):
    """The same scenes with their boxes, for the fine-tune task."""

    def __getitem__(self, idx: int, seed=None) -> dict:
        from .transforms import pad_boxes, pad_points
        pts, boxes, labels = self.scene(idx, seed)
        p, v = pad_points(pts, self.cfg.caps.max_points)
        b, lab, m = pad_boxes(boxes, labels, self.cfg.max_gt_boxes)
        return dict(points=p, point_valid=v, gt_boxes=b, gt_labels=lab,
                    gt_mask=m)
