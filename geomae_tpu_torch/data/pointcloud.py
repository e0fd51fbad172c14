"""Host-side point-cloud IO: nuScenes .bin decode, multi-sweep merge.

The port's copy of ``geomae_tpu/data/pointcloud.py``, the same numpy
functions.  It rebuilds mmdet3d's ``LoadPointsFromFile``
(``mmdet3d/datasets/pipelines/loading.py:337``) and
``LoadPointsFromMultiSweeps`` (``loading.py:100``): load the key frame's
[x y z intensity ring] float32 records, append up to ``sweeps_num`` past
sweeps transformed into the key frame via ``sensor2lidar_{rotation,
translation}``, with a time-lag channel replacing the ring index and
``remove_close`` filtering of ego returns.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def load_points_bin(path: str, load_dim: int = 5,
                    use_dim: int = 5) -> np.ndarray:
    """Read an [N, load_dim] float32 .bin file (nuScenes layout)."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, load_dim)
    return pts[:, :use_dim]


def remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Drop ego-vehicle returns within ``radius`` m in BEV (loading.py:163)."""
    keep = ~((np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius))
    return points[keep]


def merge_sweeps(info: Dict, data_root: str, sweeps_num: int = 9,
                 load_dim: int = 5, use_dim: int = 5,
                 remove_close_radius: float = 1.0,
                 pad_empty_sweeps: bool = True,
                 test_mode: bool = True,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Key frame + past sweeps in the key lidar frame, 5-channel output.

    ``info`` follows the nuScenes info pkl schema: ``lidar_path``,
    ``timestamp`` (us), ``sweeps`` — each sweep a dict with ``data_path``,
    ``sensor2lidar_rotation`` [3,3], ``sensor2lidar_translation`` [3],
    ``timestamp``.  Output channels: x y z intensity time_lag(s).  In
    train mode (``test_mode=False`` with an ``rng``) a frame with more
    sweeps than ``sweeps_num`` takes a random choice of them.
    """
    key = load_points_bin(_abspath(info["lidar_path"], data_root),
                          load_dim, use_dim).copy()
    key[:, 4] = 0.0
    ts = info["timestamp"] / 1e6
    out: List[np.ndarray] = [remove_close(key, remove_close_radius)]

    sweeps = info.get("sweeps", [])
    if len(sweeps) == 0:
        if pad_empty_sweeps:
            for _ in range(sweeps_num):
                out.append(out[0])
    else:
        if len(sweeps) <= sweeps_num:
            chosen = list(range(len(sweeps)))
        elif test_mode or rng is None:
            chosen = list(range(sweeps_num))
        else:
            chosen = list(rng.choice(len(sweeps), sweeps_num, replace=False))
        for i in chosen:
            sw = sweeps[i]
            pts = load_points_bin(_abspath(sw["data_path"], data_root),
                                  load_dim, use_dim).copy()
            pts = remove_close(pts, remove_close_radius)
            R = np.asarray(sw["sensor2lidar_rotation"], np.float32)
            t = np.asarray(sw["sensor2lidar_translation"], np.float32)
            pts[:, :3] = pts[:, :3] @ R.T + t
            pts[:, 4] = ts - sw["timestamp"] / 1e6
            out.append(pts)

    return np.concatenate(out, axis=0).astype(np.float32)


def _abspath(path: str, data_root: str) -> str:
    if os.path.isabs(path) or not data_root:
        return path
    # reference infos store paths relative to the repo cwd ("data/nuscenes/…")
    if os.path.exists(path):
        return path
    cand = os.path.join(data_root, path)
    if os.path.exists(cand):
        return cand
    # the info path may embed its own root prefix ("data/nuscenes/samples/
    # LIDAR_TOP/x.bin" with data_root elsewhere): strip leading components
    # until something resolves under data_root
    parts = path.split("/")
    for i in range(1, len(parts)):
        cand = os.path.join(data_root, *parts[i:])
        if os.path.exists(cand):
            return cand
    return os.path.join(data_root, os.path.basename(path))
