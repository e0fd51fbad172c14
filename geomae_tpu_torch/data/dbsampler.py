"""GT-database paste augmentation (ObjectSample).

The port's copy of ``geomae_tpu/data/dbsampler.py``: mmdet3d's
``DataBaseSampler`` + the ``ObjectSample`` transform
(``mmdet3d/datasets/pipelines/dbsampler.py:374`` and
``pipelines/transforms_3d.py:241``): sample extra ground-truth objects per
class up to the configured group counts, reject samples whose BEV boxes
collide with existing or already-sampled boxes, paste their points into the
scene and remove scene points inside the pasted boxes.

Config defaults match ``configs/pre_sst/...6x_1e-5.py:38-71`` (filter by
min 5 points; per-class sample groups).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_SAMPLE_GROUPS = dict(
    car=2, truck=3, construction_vehicle=7, bus=4, trailer=6, barrier=2,
    motorcycle=6, bicycle=6, pedestrian=2, traffic_cone=2)
DEFAULT_MIN_POINTS = 5


def _bev_corners(boxes: np.ndarray) -> np.ndarray:
    x, y, dx, dy, yaw = (boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4],
                         boxes[:, 6])
    c, s = np.cos(yaw), np.sin(yaw)
    lx = np.stack([dx, dx, -dx, -dx], -1) / 2
    ly = np.stack([-dy, dy, dy, -dy], -1) / 2
    return np.stack([x[:, None] + lx * c[:, None] - ly * s[:, None],
                     y[:, None] + lx * s[:, None] + ly * c[:, None]], -1)


def _bev_collide(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Conservative BEV collision [Na, Nb] via circumscribed circles then
    axis-aligned bounds of corners (cheap; used only for rejection)."""
    ca, cb = _bev_corners(a), _bev_corners(b)
    lo_a, hi_a = ca.min(1), ca.max(1)
    lo_b, hi_b = cb.min(1), cb.max(1)
    sep = ((hi_a[:, None, 0] < lo_b[None, :, 0])
           | (hi_b[None, :, 0] < lo_a[:, None, 0])
           | (hi_a[:, None, 1] < lo_b[None, :, 1])
           | (hi_b[None, :, 1] < lo_a[:, None, 1]))
    return ~sep


class DataBaseSampler:
    def __init__(self, data_root: str, info_path: str,
                 classes: Sequence[str],
                 sample_groups: Optional[Dict[str, int]] = None,
                 min_points: int = DEFAULT_MIN_POINTS,
                 load_dim: int = 5):
        self.data_root = data_root
        self.classes = list(classes)
        self.groups = sample_groups or DEFAULT_SAMPLE_GROUPS
        self.load_dim = load_dim
        with open(info_path, "rb") as f:
            db = pickle.load(f)
        self.db: Dict[str, List[Dict]] = {
            name: [d for d in infos
                   if d.get("num_points_in_gt", 0) >= min_points]
            for name, infos in db.items() if name in self.classes}

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        boxes = sample.get("boxes")
        labels = sample.get("labels")
        if boxes is None:
            return sample
        boxes = boxes.copy()
        labels = labels.copy()
        points = sample["points"]

        new_boxes, new_labels, new_points = [], [], []
        avoid = boxes
        for cname, want in self.groups.items():
            pool = self.db.get(cname, [])
            if not pool or cname not in self.classes:
                continue
            have = int((labels == self.classes.index(cname)).sum())
            need = max(want - have, 0)
            if need == 0:
                continue
            picks = rng.choice(len(pool), min(need, len(pool)), replace=False)
            for k in picks:
                d = pool[k]
                b = np.asarray(d["box3d_lidar"], np.float32)
                if b.shape[0] == 7:
                    b = np.concatenate([b, np.zeros(2, np.float32)])
                cand = b[None]
                if len(avoid) and _bev_collide(cand, avoid).any():
                    continue
                path = os.path.join(self.data_root, d["path"])
                try:
                    obj = np.fromfile(path, np.float32).reshape(
                        -1, self.load_dim)
                except (FileNotFoundError, ValueError):
                    continue
                obj = obj.copy()
                obj[:, :3] += b[:3]
                if obj.shape[1] >= 5:
                    obj[:, 4] = 0.0          # pasted points are "current"
                new_boxes.append(b)
                new_labels.append(self.classes.index(cname))
                new_points.append(obj)
                avoid = np.concatenate([avoid, cand]) if len(avoid) else cand

        if not new_boxes:
            return sample
        nb = np.stack(new_boxes)
        # remove original points inside pasted boxes
        keep = np.ones(len(points), bool)
        for b in nb:
            d = points[:, :3] - b[:3]
            c, s = np.cos(-b[6]), np.sin(-b[6])
            lx = d[:, 0] * c - d[:, 1] * s
            ly = d[:, 0] * s + d[:, 1] * c
            keep &= ~((np.abs(lx) <= b[3] / 2) & (np.abs(ly) <= b[4] / 2)
                      & (d[:, 2] >= 0) & (d[:, 2] <= b[5]))
        points = np.concatenate([points[keep]] + new_points)
        boxes = np.concatenate([boxes, nb]) if len(boxes) else nb
        labels = np.concatenate([labels, np.asarray(new_labels, labels.dtype)])
        return dict(sample, points=points, boxes=boxes, labels=labels)
