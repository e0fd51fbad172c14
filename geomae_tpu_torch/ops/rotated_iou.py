"""Rotated BEV IoU, branch-free, and the greedy NMS over it.

Port of ``geomae_tpu/ops/rotated_iou.py`` (``rect_intersection_area``,
``boxes_iou_bev``, ``nms_bev``, ``circle_nms``).  Each pair of rectangles gives 24 candidate vertices
(16 edge crossings, 4 corners of A in B, 4 of B in A); the intersection is
convex, so sorting the valid candidates by angle around their mean and
taking the shoelace area gives its area.  The NMS functions take many
rankings at once (the CenterHead's tasks, the samples of a batch) and
run one greedy loop for all of them (``greedy_keep``).
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


def boxes_iou_bev_batched(boxes: torch.Tensor,
                          pairs_per_chunk: int = 1 << 20) -> torch.Tensor:
    """Rotated BEV IoU of every pair within each row of boxes [N, K, 5]:
    [N, K, K].  The N * K query rows go through ``rect_intersection_area``
    in chunks of about ``pairs_per_chunk`` pairs, so many rankings cost a
    few calls instead of one call per ranking."""
    N, K = boxes.shape[:2]
    area = boxes[..., 2] * boxes[..., 3]
    a = boxes[:, :, None, :].expand(N, K, K, 5).reshape(N * K, K, 5)
    b = boxes[:, None, :, :].expand(N, K, K, 5).reshape(N * K, K, 5)
    rows = max(pairs_per_chunk // max(K, 1), 1)
    inter = torch.cat([rect_intersection_area(x, y) for x, y in
                       zip(a.split(rows), b.split(rows))]).reshape(N, K, K)
    union = area[:, :, None] + area[:, None, :] - inter
    return inter / union.clamp_min(1e-8)


def greedy_keep(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy suppression for N rankings at once: sup [N, K, K] (candidate
    i of a row suppresses j where set), valid [N, K], each row in ranked
    order.  Step i lets the i-th candidate of every row, if still alive
    and valid, remove every other candidate it suppresses: the JAX
    ``fori_loop`` of ``nms_bev`` run for all rows together.  Returns the
    keep mask [N, K]."""
    sup = sup.clone()
    sup.diagonal(dim1=1, dim2=2).fill_(False)
    alive = torch.ones_like(valid)
    for i in range(valid.shape[1]):
        keep_i = alive[:, i] & valid[:, i]
        alive &= ~(sup[:, i] & keep_i[:, None])
    return alive & valid


def _first(keep: torch.Tensor, max_out: int) -> torch.Tensor:
    """The first ``max_out`` kept candidates of each row (ranked order)."""
    return keep & (keep.long().cumsum(-1) <= max_out)


def _thresholds(thr, n: int, device) -> torch.Tensor:
    """One threshold per row [n, 1, 1], from a number or a sequence."""
    t = torch.as_tensor(thr, dtype=torch.float32, device=device)
    return t.expand(n).reshape(n, 1, 1)


def nms_bev(boxes5: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
            iou_thr, max_out: int) -> torch.Tensor:
    """Greedy rotated-BEV NMS (``geomae_tpu/ops/rotated_iou.py:nms_bev``)
    over candidates already sorted by descending score: boxes5 [..., K,
    5], scores and valid [..., K]; every leading index is a ranking of its
    own, and all of them share one greedy loop of K steps.  ``iou_thr``
    is a number or one threshold per ranking (the leading axes
    flattened).  A candidate is suppressed by a kept one above it whose
    IoU exceeds the threshold.  Returns the keep mask [..., K], at most
    ``max_out`` set per ranking, best first."""
    lead, K = valid.shape[:-1], valid.shape[-1]
    b = boxes5.reshape(-1, K, 5)
    sup = boxes_iou_bev_batched(b) > _thresholds(iou_thr, b.shape[0],
                                                 b.device)
    keep = greedy_keep(sup, valid.reshape(-1, K))
    return _first(keep, max_out).reshape(*lead, K)


def circle_nms(centers: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, min_radius: float,
               max_out: int) -> torch.Tensor:
    """Greedy centre-distance NMS (``geomae_tpu/ops/rotated_iou.py:
    circle_nms``, CenterPoint's ``circle_nms``): a kept candidate
    suppresses every later one closer than ``min_radius``.  centers [...,
    K, 2] sorted by descending score, valid [..., K], batched as
    ``nms_bev``.  Returns the keep mask [..., K]."""
    lead, K = valid.shape[:-1], valid.shape[-1]
    c = centers.reshape(-1, K, 2)
    d2 = ((c[:, :, None] - c[:, None]) ** 2).sum(-1)
    keep = greedy_keep(d2 < min_radius ** 2, valid.reshape(-1, K))
    return _first(keep, max_out).reshape(*lead, K)
