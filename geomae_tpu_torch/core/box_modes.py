"""3D box coordinate-mode conversions (LiDAR / Camera / Depth).

The port's copy of ``geomae_tpu/core/box_modes.py``, a numpy rebuild of
mmdet3d's ``Box3DMode`` (``core/bbox/structures/box_3d_mode.py:12-166``):
boxes are ``[N, 7+]`` arrays ``(x, y, z, dx, dy, dz, yaw, ...)`` whose
frame conventions differ per mode —

* LiDAR: x front / y left / z up; yaw about +z; bottom-center origin.
* Camera: x right / y down / z front; yaw about +y.
* Depth:  x right / y front / z up; yaw about +z.

``convert`` rotates the centers with the (given or default sensor-less)
rotation matrix and permutes the size dims exactly like the reference;
extra columns (velocity, score, ...) pass through.  This is a host-side
data-prep utility (the device path stays entirely in LiDAR frame), so it
is plain numpy by design.
"""
from __future__ import annotations

from enum import IntEnum, unique

import numpy as np


@unique
class Box3DMode(IntEnum):
    LIDAR = 0
    CAM = 1
    DEPTH = 2


# default (sensor-less) rotation and the size-dim permutation per pair,
# matching the reference's tables (box_3d_mode.py:104-127)
_DEFAULT = {
    (Box3DMode.LIDAR, Box3DMode.CAM):
        ([[0, -1, 0], [0, 0, -1], [1, 0, 0]], (1, 2, 0)),
    (Box3DMode.CAM, Box3DMode.LIDAR):
        ([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], (2, 0, 1)),
    (Box3DMode.DEPTH, Box3DMode.CAM):
        ([[1, 0, 0], [0, 0, 1], [0, -1, 0]], (0, 2, 1)),
    (Box3DMode.CAM, Box3DMode.DEPTH):
        ([[1, 0, 0], [0, 0, -1], [0, 1, 0]], (0, 2, 1)),
    (Box3DMode.LIDAR, Box3DMode.DEPTH):
        ([[0, -1, 0], [1, 0, 0], [0, 0, 1]], (1, 0, 2)),
    (Box3DMode.DEPTH, Box3DMode.LIDAR):
        ([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], (1, 0, 2)),
}


def convert(boxes: np.ndarray, src: Box3DMode, dst: Box3DMode,
            rt_mat: np.ndarray | None = None) -> np.ndarray:
    """Convert ``[N, >=7]`` boxes between modes.  ``rt_mat`` may be a
    [3, 3] rotation or [3, 4]/[4, 4] rotation+translation from the src to
    the dst frame (e.g. a lidar2cam extrinsic); default is the pure
    axis-relabeling of the reference."""
    boxes = np.asarray(boxes, np.float64)
    if src == dst:
        return boxes.copy()
    if (src, dst) not in _DEFAULT:
        raise NotImplementedError(f"{src} -> {dst}")
    default_rt, perm = _DEFAULT[(src, dst)]
    if rt_mat is None:
        rt_mat = np.asarray(default_rt, np.float64)
    rt_mat = np.asarray(rt_mat, np.float64)

    xyz = boxes[..., :3]
    if rt_mat.shape[-1] == 4:
        xyz = xyz @ rt_mat[:3, :3].T + rt_mat[:3, 3]
    else:
        xyz = xyz @ rt_mat.T
    sizes = boxes[..., 3:6][..., list(perm)]
    return np.concatenate([xyz, sizes, boxes[..., 6:]], axis=-1)
