"""Weighted NMS ("wnms"): test-time box merging by score-weighted voting.

The port's copy of ``geomae_tpu/core/wnms.py``: numpy on the host, the
IoU matrices through the port's rotated IoU (``ops/rotated_iou.py``) on
a device of the caller's choice, the CPU by default (the anchor head's
``predict_wnms`` passes its predictions' device, as the JAX package's
IoU runs on its default device).
Like that module it re-implements the reference's C++ weighted NMS and
its callers:

* ``wnms_4c`` greedy suppress + vote loop
  (``mmdet3d/ops/wnms/src/nms.h:455-580``, exported by
  ``wnms.cpp:6-7``; the corner-resequencing ``match_4c_box`` is computed
  but DISABLED there — ``box4c_ = neigh`` — so it is omitted here);
* ``get_wnms_bboxes`` box -> 11-dim corner det conversion
  (``mmdet3d/models/dense_heads/anchor3d_head.py:553-571``);
* ``det11_to_xyzwhlr`` inverse conversion
  (``mmdet3d/core/bbox/structures/utils.py:63-83``);
* ``box3d_multiclass_wnms`` per-class driver
  (``mmdet3d/core/post_processing/box3d_nms.py:12-107``).

Host-side numpy by design: the reference runs this on CPU as well (the
GPU variant raises ``NotImplementedError``), the greedy scan is
inherently sequential, and it only runs at test time on O(100) boxes.
The O(N^2) rotated-IoU matrix is the one heavy part and is computed in a
single vectorized call (the port's ``ops.rotated_iou.boxes_iou_bev``).

Semantics preserved from the C++:

* dets are [N, 12]: 8 BEV corner coords (4 x xy), yaw, bottom z, height,
  score; processing order is descending score;
* one pass per surviving top box i: later boxes with IoU >= ``thresh``
  are suppressed; boxes with IoU > ``thresh_vote`` vote (note the
  reference calls this with thresh=thr_lo=0.1, thresh_vote=thr_hi=0.7 —
  suppression is the LOOSER threshold);
* voters outside 0.3 rad of the neighborhood's median yaw (median
  includes i's own yaw again when the count is even and > 2) are
  dropped; survivors' 11 box dims are averaged weighted by their score;
* the merged det keeps box i's score and index.
"""
from __future__ import annotations

import numpy as np

_PI = 3.1415926  # the C++ constant (nms.h:544), not np.pi


def boxes7_to_det11(boxes: np.ndarray) -> np.ndarray:
    """[N, 7] (x, y, z_bottom, dx, dy, dz, yaw) -> [N, 11] corner dets.

    Mirrors ``get_wnms_bboxes``: the 4 bottom BEV corners in the
    reference's ``corners[:, [0, 3, 7, 4], :2]`` order — local
    (-dx,-dy), (-dx,+dy), (+dx,+dy), (+dx,-dy) halves rotated by yaw —
    then yaw, bottom z, height.
    """
    boxes = np.asarray(boxes, np.float32)
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    lx = np.stack([-dx, -dx, dx, dx], -1) * 0.5
    ly = np.stack([-dy, dy, dy, -dy], -1) * 0.5
    cs, sn = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    cx = x[:, None] + lx * cs - ly * sn
    cy = y[:, None] + lx * sn + ly * cs
    xy8 = np.stack([cx, cy], -1).reshape(-1, 8)
    return np.concatenate(
        [xy8, yaw[:, None], boxes[:, 2:3], boxes[:, 5:6]], -1)


def det11_to_boxes7(det11: np.ndarray) -> np.ndarray:
    """Inverse of :func:`boxes7_to_det11` (``det11_to_xyzwhlr``): center
    = corner mean, dx = |c0 - c3|, dy = |c0 - c1|, z/height/yaw copied."""
    det11 = np.asarray(det11, np.float32)
    xy4 = det11[:, :8].reshape(-1, 4, 2)
    ctr = xy4.mean(axis=1)
    dx = np.linalg.norm(xy4[:, 0] - xy4[:, 3], axis=-1, keepdims=True)
    dy = np.linalg.norm(xy4[:, 0] - xy4[:, 1], axis=-1, keepdims=True)
    return np.concatenate(
        [ctr, det11[:, 9:10], dx, dy, det11[:, 10:11], det11[:, 8:9]], -1)


def _iou_matrix(det11: np.ndarray, use_3d: bool,
                device="cpu") -> np.ndarray:
    """Rotated BEV (or volume) IoU through the port's polygon clipper on
    ``device`` (the JAX package's runs on its default device)."""
    import torch

    from ..ops.rotated_iou import boxes_iou_bev, rect_intersection_area

    b7 = det11_to_boxes7(det11)
    b5 = torch.from_numpy(np.ascontiguousarray(b7[:, [0, 1, 3, 4, 6]])
                          ).to(device)
    if not use_3d:
        return boxes_iou_bev(b5, b5).cpu().numpy()
    n = b7.shape[0]
    inter = rect_intersection_area(b5[:, None, :].expand(n, n, 5),
                                   b5[None].expand(n, n, 5)).cpu().numpy()
    bot, h = det11[:, 9], det11[:, 10]
    top = bot + h
    hover = np.maximum(
        np.minimum(top[:, None], top[None]) -
        np.maximum(bot[:, None], bot[None]), 0.0)
    vol = (b7[:, 3] * b7[:, 4] * h)
    inter_v = inter * hover
    return inter_v / np.maximum(vol[:, None] + vol[None] - inter_v, 1e-8)


def weighted_nms(dets12: np.ndarray, thresh: float, thresh_vote: float,
                 use_3d: bool = False, device="cpu"):
    """Greedy weighted NMS over [N, 12] corner dets (module docstring),
    the IoU matrix computed on ``device``.

    Returns (merged dets [K, 12], kept indices [K])."""
    dets12 = np.asarray(dets12, np.float32)
    n = dets12.shape[0]
    if n == 0:
        return np.zeros((0, 12), np.float32), np.zeros((0,), np.int64)
    scores = dets12[:, 11]
    yaw = dets12[:, 8]
    order = np.argsort(-scores, kind="stable")
    iou = _iou_matrix(dets12[:, :11], use_3d, device)

    suppressed = np.zeros(n, bool)
    keep_dets, keep_inds = [], []
    for oi in range(n):
        i = order[oi]
        if suppressed[i]:
            continue
        later = order[oi + 1:]
        later = later[~suppressed[later]]
        ov = iou[i, later]
        suppressed[later[ov >= thresh]] = True
        neigh = np.concatenate([[i], later[ov > thresh_vote]])
        ny = yaw[neigh]
        if neigh.size <= 2:
            med = yaw[i]
        else:
            vals = ny if neigh.size % 2 else np.append(ny, yaw[i])
            vals = np.sort(vals, kind="stable")
            med = vals[vals.size // 2]
        votes = neigh[np.fmod(np.abs(ny - med), 2 * _PI) < 0.3]
        p = scores[votes][:, None]
        merged = (p * dets12[votes, :11]).sum(0) / p.sum(0)
        keep_dets.append(np.concatenate([merged, scores[i:i + 1]]))
        keep_inds.append(i)
    return np.stack(keep_dets), np.asarray(keep_inds, np.int64)


def box3d_multiclass_wnms(mlvl_bboxes: np.ndarray, mlvl_scores: np.ndarray,
                          score_thr: float, max_num: int,
                          thr_suppress: float = 0.1, thr_vote: float = 0.7,
                          use_3d: bool = False,
                          mlvl_dir_scores: np.ndarray | None = None,
                          device="cpu"):
    """Per-class weighted NMS over decoded boxes, each class's IoU matrix
    computed on ``device``.

    Args:
      mlvl_bboxes: [N, 7] (x, y, z_bottom, dx, dy, dz, yaw).
      mlvl_scores: [N, num_classes (+1 bg ignored)] sigmoid scores.
      thr_suppress/thr_vote: the reference's wnms_thr_lo/hi defaults.
    Returns (boxes [K, 7], scores [K], labels [K], dir_scores [K]).
    """
    mlvl_bboxes = np.asarray(mlvl_bboxes, np.float32)
    mlvl_scores = np.asarray(mlvl_scores, np.float32)
    num_classes = mlvl_scores.shape[1] - 1
    det11 = boxes7_to_det11(mlvl_bboxes) if mlvl_bboxes.size else None
    bb, ss, ll, dd = [], [], [], []
    for c in range(num_classes):
        if mlvl_bboxes.shape[0] == 0:
            continue
        keep = mlvl_scores[:, c] > score_thr
        if not keep.any():
            continue
        dets = np.concatenate(
            [det11[keep], mlvl_scores[keep, c:c + 1]], -1)
        det12, kinds = weighted_nms(dets, thr_suppress, thr_vote, use_3d,
                                    device)
        bb.append(det11_to_boxes7(det12[:, :11]))
        ss.append(det12[:, 11])
        ll.append(np.full(len(kinds), c, np.int64))
        if mlvl_dir_scores is not None:
            dd.append(np.asarray(mlvl_dir_scores)[keep][kinds])
    if not bb:
        z = np.zeros
        return (z((0, mlvl_bboxes.shape[-1] if mlvl_bboxes.size else 7),
                  np.float32), z((0,), np.float32), z((0,), np.int64),
                z((0,), np.float32))
    boxes = np.concatenate(bb)
    sc = np.concatenate(ss)
    lab = np.concatenate(ll)
    ds = (np.concatenate(dd) if dd else np.zeros(len(sc), np.float32))
    if len(sc) > max_num:
        top = np.argsort(-sc, kind="stable")[:max_num]
        boxes, sc, lab, ds = boxes[top], sc[top], lab[top], ds[top]
    return boxes, sc, lab, ds
