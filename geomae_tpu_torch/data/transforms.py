"""Host-side (numpy) point and box preparation.

The port's copies of ``points_range_filter``, ``pad_points`` and
``pad_boxes`` from ``geomae_tpu/data/transforms.py``, the same numpy
functions: a request or a training frame is range-filtered and padded
to the static point cap before it reaches the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def points_range_filter(sample: Dict, pc_range: Sequence[float]) -> Dict:
    pts = sample["points"]
    m = ((pts[:, 0] >= pc_range[0]) & (pts[:, 0] < pc_range[3])
         & (pts[:, 1] >= pc_range[1]) & (pts[:, 1] < pc_range[4])
         & (pts[:, 2] >= pc_range[2]) & (pts[:, 2] < pc_range[5]))
    return dict(sample, points=pts[m])


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
