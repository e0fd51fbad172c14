"""LiDAR box utilities on the serving path.

Port of the parts of ``geomae_tpu/core/boxes.py`` that detection needs.
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


def bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, dx, dy, yaw) rotated BEV boxes."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], -1)


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
