"""LiDAR box utilities of the detection path.

Port of ``geomae_tpu/core/boxes.py``: what serving and the anchor head's
target assignment need, gravity centres and the point-in-box test.
Boxes are ``[..., 7+]`` tensors ``(x, y, z_bottom, w, l, h, yaw, ...)`` in
the LiDAR frame.
"""
from __future__ import annotations

import math

import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    """Map to ``[-offset * period, (1 - offset) * period)``."""
    return val - torch.floor(val / period + offset) * period


def gravity_center(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 3] centres with z at the box's middle (boxes store the bottom
    z)."""
    return torch.cat([boxes[..., :2], boxes[..., 2:3] + boxes[..., 5:6] * 0.5],
                     -1)


def bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, dx, dy, yaw) rotated BEV boxes."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], -1)


def nearest_bev(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV [..., 4] (x1, y1, x2, y2) after turning each box to
    its nearest axis: dx and dy swap when yaw (mod pi) is nearer pi/2."""
    b = bev(boxes)
    rot = limit_period(b[..., 4], 0.5, math.pi)
    cond = (torch.abs(rot) > math.pi / 4)[..., None]
    dims = torch.where(cond, b[..., [3, 2]], b[..., 2:4])
    ctr = b[..., :2]
    return torch.cat([ctr - dims / 2, ctr + dims / 2], -1)


def aligned_iou_2d(boxes1: torch.Tensor, boxes2: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Axis-aligned 2D IoU matrix: [N, 4] x [M, 4] -> [N, M]."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return inter / torch.clamp(union, min=eps)


def corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4, 2] BEV corners, counter-clockwise."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    cs, sn = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([dx, dx, -dx, -dx], -1) * 0.5
    ly = torch.stack([-dy, dy, dy, -dy], -1) * 0.5
    cx = x[..., None] + lx * cs[..., None] - ly * sn[..., None]
    cy = y[..., None] + lx * sn[..., None] + ly * cs[..., None]
    return torch.stack([cx, cy], -1)


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Bool [..., P, N]: point inside rotated box, z within [z, z + h]
    (the roiaware_pool3d ``points_in_boxes_gpu`` op of mmdet3d): points
    [..., P, >=3] turned into each box's frame of boxes [..., N, >=7]
    and held to the half-dimensions."""
    local = points[..., :, None, :3] - boxes[..., None, :, :3]
    yaw = boxes[..., None, :, 6]
    cs, sn = torch.cos(-yaw), torch.sin(-yaw)
    lx = local[..., 0] * cs - local[..., 1] * sn
    ly = local[..., 0] * sn + local[..., 1] * cs
    lz = local[..., 2]
    half = boxes[..., None, :, :]
    return ((torch.abs(lx) <= half[..., 3] / 2)
            & (torch.abs(ly) <= half[..., 4] / 2)
            & (lz >= 0) & (lz <= half[..., 5]))
