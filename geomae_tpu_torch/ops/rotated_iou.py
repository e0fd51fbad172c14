"""Rotated BEV IoU, branch-free.

Port of ``geomae_tpu/ops/rotated_iou.py`` (``rect_intersection_area``,
``boxes_iou_bev``).  Each pair of rectangles gives 24 candidate vertices
(16 edge crossings, 4 corners of A in B, 4 of B in A); the intersection is
convex, so sorting the valid candidates by angle around their mean and
taking the shoelace area gives its area.
"""
from __future__ import annotations

import torch

from ..core.boxes import corners_bev

_EPS = 1e-8


def _point_in_rect(pts: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """pts [..., P, 2] inside rotated rect [..., 5] (x, y, dx, dy, yaw)."""
    d = pts - rect[..., None, 0:2]
    cs, sn = torch.cos(rect[..., 4]), torch.sin(rect[..., 4])
    lx = d[..., 0] * cs[..., None] + d[..., 1] * sn[..., None]
    ly = -d[..., 0] * sn[..., None] + d[..., 1] * cs[..., None]
    return ((lx.abs() <= rect[..., None, 2] * 0.5 + 1e-5)
            & (ly.abs() <= rect[..., None, 3] * 0.5 + 1e-5))


def _segment_intersections(ca: torch.Tensor, cb: torch.Tensor):
    """The 16 edge-pair crossings of two quads [..., 4, 2]:
    (pts [..., 16, 2], valid [..., 16])."""
    a1 = ca[..., :, None, :]
    a2 = torch.roll(ca, -1, dims=-2)[..., :, None, :]
    b1 = cb[..., None, :, :]
    b2 = torch.roll(cb, -1, dims=-2)[..., None, :, :]
    da = a2 - a1
    db = b2 - b1
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    ok_d = denom.abs() >= _EPS
    safe = torch.where(ok_d, denom, torch.ones_like(denom))
    ab = b1 - a1
    t = (ab[..., 0] * db[..., 1] - ab[..., 1] * db[..., 0]) / safe
    u = (ab[..., 0] * da[..., 1] - ab[..., 1] * da[..., 0]) / safe
    ok = ok_d & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = a1 + t[..., None] * da
    shp = pts.shape[:-3] + (16, 2)
    return pts.reshape(shp), ok.reshape(shp[:-1])


def _corners5(b: torch.Tensor) -> torch.Tensor:
    """Corners [..., 4, 2] of (x, y, dx, dy, yaw) boxes."""
    zero = torch.zeros_like(b[..., 0:1])
    fake = torch.cat([b[..., 0:2], zero, b[..., 2:4], zero + 1, b[..., 4:5]],
                     -1)
    return corners_bev(fake)


def rect_intersection_area(boxes_a: torch.Tensor,
                           boxes_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated BEV boxes [..., 5], pairwise along the
    leading axes."""
    ca = _corners5(boxes_a)
    cb = _corners5(boxes_b)
    p_int, v_int = _segment_intersections(ca, cb)
    pts = torch.cat([p_int, ca, cb], -2)                      # [..., 24, 2]
    valid = torch.cat([v_int, _point_in_rect(ca, boxes_b),
                       _point_in_rect(cb, boxes_a)], -1)
    n = valid.sum(-1, keepdim=True)                           # [..., 1]
    ctr = (torch.where(valid[..., None], pts, 0.0).sum(-2, keepdim=True)
           / n.clamp_min(1)[..., None])
    rel = pts - ctr
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]), 1e3)
    order = torch.argsort(ang, dim=-1, stable=True)
    rel = torch.gather(rel, -2, order[..., None].expand_as(rel))
    K = pts.shape[-2]
    i = torch.arange(K, device=pts.device)
    nxt = torch.roll(rel, -1, dims=-2)
    cross = rel[..., 0] * nxt[..., 1] - rel[..., 1] * nxt[..., 0]
    inner = torch.where(i < n - 1, cross, 0.0).sum(-1)
    last_i = (n - 1).clamp(0, K - 1)[..., None].expand(*rel.shape[:-2], 1, 2)
    last = torch.gather(rel, -2, last_i)[..., 0, :]
    first = rel[..., 0, :]
    closing = last[..., 0] * first[..., 1] - last[..., 1] * first[..., 0]
    area = 0.5 * (inner + closing).abs()
    return torch.where(n[..., 0] >= 3, area, 0.0)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                  row_chunk: int = 128) -> torch.Tensor:
    """Rotated BEV IoU matrix [N, M] of boxes [N, 5] and [M, 5], computed
    in chunks of rows to bound the [rows, M, 24, 2] candidates."""
    M = boxes_b.shape[0]
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    inter = torch.cat([
        rect_intersection_area(
            chunk[:, None, :].expand(-1, M, -1),
            boxes_b[None, :, :].expand(chunk.shape[0], -1, -1))
        for chunk in boxes_a.split(row_chunk)])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-8)
