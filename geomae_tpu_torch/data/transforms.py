"""Host-side (numpy) augmentation and padding pipeline.

The port's copy of ``geomae_tpu/data/transforms.py``, the same numpy
functions, rebuilding the GeoMAE train pipeline transforms of mmdet3d
(``mmdet3d/datasets/pipelines/transforms_3d.py``):

* ``GlobalRotScaleTrans`` (``:607``): order is rotate -> scale -> translate
  (``:749-757``), uniform rot in ``rot_range`` about +z, uniform scale,
  gaussian translation.  Boxes rotate with points.
* ``RandomFlip3D`` (``:59``): independent BEV horizontal (y := -y) and
  vertical (x := -x) flips, each p=0.5.
* ``PointsRangeFilter`` (``:849``) / ``ObjectRangeFilter`` (``:803``) /
  ``PointShuffle`` (``:771``).

A request or a training frame is range-filtered and padded to the static
point cap (``pad_points``) before it reaches the device.  All functions
take and return a dict so they compose like the reference's pipeline
list; boxes are [N, 7+] (x y z w l h yaw [vx vy]).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    # matches mmdet3d rotation convention: points @ R with
    # R = [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)


def global_rot_scale_trans(sample: Dict, rng: np.random.Generator,
                           rot_range=(-0.3925, 0.3925),
                           scale_range=(0.95, 1.05),
                           translation_std=(0.0, 0.0, 0.0)) -> Dict:
    pts = sample["points"]
    angle = rng.uniform(rot_range[0], rot_range[1])
    scale = rng.uniform(scale_range[0], scale_range[1])
    trans = rng.normal(scale=translation_std, size=3).astype(np.float32)

    R = rotation_z(angle)
    pts = pts.copy()
    pts[:, :3] = pts[:, :3] @ R
    pts[:, :3] *= scale
    pts[:, :3] += trans
    sample = dict(sample, points=pts)

    if sample.get("boxes") is not None and len(sample["boxes"]):
        b = sample["boxes"].copy()
        b[:, :3] = b[:, :3] @ R
        b[:, 6] += angle
        b[:, :6] *= scale
        b[:, :3] += trans
        if b.shape[1] > 7:      # velocities rotate+scale, no translate
            vel = np.concatenate([b[:, 7:9],
                                  np.zeros((len(b), 1), b.dtype)], 1)
            b[:, 7:9] = (vel @ R)[:, :2] * scale
        sample["boxes"] = b
    return sample


def random_flip_3d(sample: Dict, rng: np.random.Generator,
                   flip_ratio_horizontal=0.5, flip_ratio_vertical=0.5) -> Dict:
    pts = sample["points"].copy()
    boxes = None if sample.get("boxes") is None else sample["boxes"].copy()
    if rng.random() < flip_ratio_horizontal:   # flip y
        pts[:, 1] = -pts[:, 1]
        if boxes is not None and len(boxes):
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
            if boxes.shape[1] > 7:
                boxes[:, 8] = -boxes[:, 8]
    if rng.random() < flip_ratio_vertical:     # flip x
        pts[:, 0] = -pts[:, 0]
        if boxes is not None and len(boxes):
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -boxes[:, 6] + np.pi
            if boxes.shape[1] > 7:
                boxes[:, 7] = -boxes[:, 7]
    out = dict(sample, points=pts)
    if boxes is not None:
        out["boxes"] = boxes
    return out


def points_range_filter(sample: Dict, pc_range: Sequence[float]) -> Dict:
    pts = sample["points"]
    m = ((pts[:, 0] >= pc_range[0]) & (pts[:, 0] < pc_range[3])
         & (pts[:, 1] >= pc_range[1]) & (pts[:, 1] < pc_range[4])
         & (pts[:, 2] >= pc_range[2]) & (pts[:, 2] < pc_range[5]))
    return dict(sample, points=pts[m])


def object_range_filter(sample: Dict, pc_range: Sequence[float]) -> Dict:
    b = sample.get("boxes")
    if b is None or not len(b):
        return sample
    m = ((b[:, 0] >= pc_range[0]) & (b[:, 0] < pc_range[3])
         & (b[:, 1] >= pc_range[1]) & (b[:, 1] < pc_range[4]))
    out = dict(sample, boxes=b[m])
    if sample.get("labels") is not None:
        out["labels"] = sample["labels"][m]
    return out


def point_shuffle(sample: Dict, rng: np.random.Generator) -> Dict:
    pts = sample["points"]
    return dict(sample, points=pts[rng.permutation(len(pts))])


def pad_points(points: np.ndarray, cap: int,
               rng: Optional[np.random.Generator] = None):
    """Pad/truncate to the static cap.  Overflow keeps a uniform random
    subset (points are pre-shuffled in the train pipeline, so plain
    truncation is already a random subsample at train time)."""
    n = len(points)
    out = np.zeros((cap, points.shape[1]), np.float32)
    if n > cap:
        if rng is not None:
            idx = rng.choice(n, cap, replace=False)
            out[:] = points[idx]
        else:
            out[:] = points[:cap]
        valid = np.ones(cap, bool)
    else:
        out[:n] = points
        valid = np.zeros(cap, bool)
        valid[:n] = True
    return out, valid


def pad_boxes(boxes: np.ndarray, labels: np.ndarray, cap: int):
    nb = min(len(boxes), cap)
    out_b = np.zeros((cap, boxes.shape[1] if len(boxes) else 9), np.float32)
    out_l = np.full((cap,), -1, np.int32)
    out_b[:nb] = boxes[:nb]
    out_l[:nb] = labels[:nb]
    mask = np.zeros(cap, bool)
    mask[:nb] = True
    return out_b, out_l, mask
