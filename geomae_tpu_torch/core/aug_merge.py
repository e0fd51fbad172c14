"""Test-time-augmentation merging for 3D detections.

The port's copy of ``geomae_tpu/core/aug_merge.py``: numpy on the host,
the per-class NMS through the port's ``ops.rotated_iou.nms_bev`` on a
device of the caller's choice (``Detector3D.aug_test``: its own).  It
rebuilds the reference's aug-test post-processing:

* ``bbox3d_mapping_back`` (``mmdet3d/core/bbox/
  transforms.py:4-23``) — undo per-view flips then scale;
* LiDAR flip/scale semantics (``core/bbox/structures/lidar_box3d.py:
  168-189``, ``base_box3d.py:215-222``): horizontal flip negates y (and
  vy) with yaw -> pi - yaw; vertical flip negates x (and vx) with
  yaw -> -yaw; scale multiplies xyz+dims and velocities;
* ``merge_aug_bboxes_3d`` (``core/post_processing/merge_augs.py:7-91``)
  — map every augmented view's detections back, concatenate, per-class
  rotated-BEV NMS at ``nms_thr``, then global top-``max_num`` by score.

``geomae_tpu_torch.apis.Detector3D.aug_test`` calls this after running
the single-view predict once per augmented view, as
``VoxelNet.aug_test`` (``models/detectors/voxelnet.py:119-139``) does.
"""
from __future__ import annotations

import numpy as np


def bbox3d_mapping_back(boxes: np.ndarray, scale_factor: float,
                        flip_horizontal: bool,
                        flip_vertical: bool) -> np.ndarray:
    """Undo the view's augmentation on [N, 7|9] LiDAR boxes."""
    b = np.array(boxes, np.float32, copy=True)
    has_vel = b.shape[-1] > 7
    if flip_horizontal:
        b[:, 1] = -b[:, 1]
        if has_vel:
            b[:, 8] = -b[:, 8]
        b[:, 6] = -b[:, 6] + np.pi
    if flip_vertical:
        b[:, 0] = -b[:, 0]
        if has_vel:
            b[:, 7] = -b[:, 7]
        b[:, 6] = -b[:, 6]
    inv = 1.0 / float(scale_factor)
    b[:, :6] *= inv
    if has_vel:
        b[:, 7:9] *= inv
    return b


def merge_aug_bboxes_3d(aug_results, aug_metas, nms_thr: float,
                        max_num: int, device="cpu"):
    """Merge per-view detections (reference ``merge_aug_bboxes_3d``).

    Args:
      aug_results: list of dicts with ``boxes`` [N, 7|9], ``scores`` [N],
        ``labels`` [N] (numpy) — one per augmented view.
      aug_metas: list of dicts with ``pcd_scale_factor``,
        ``pcd_horizontal_flip``, ``pcd_vertical_flip``.
      device: where the per-class NMS runs (the CPU by default).
    Returns dict(boxes, scores, labels) merged in original coordinates.
    """
    import torch

    from ..ops.rotated_iou import nms_bev

    assert len(aug_results) == len(aug_metas)
    bb, ss, ll = [], [], []
    for res, meta in zip(aug_results, aug_metas):
        boxes = bbox3d_mapping_back(
            res["boxes"], meta.get("pcd_scale_factor", 1.0),
            meta.get("pcd_horizontal_flip", False),
            meta.get("pcd_vertical_flip", False))
        bb.append(boxes)
        ss.append(np.asarray(res["scores"], np.float32))
        ll.append(np.asarray(res["labels"], np.int64))
    boxes = np.concatenate(bb)
    scores = np.concatenate(ss)
    labels = np.concatenate(ll)
    n_total = len(scores)
    if n_total == 0:
        return dict(boxes=boxes, scores=scores, labels=labels)

    keep_parts = []
    for c in range(int(labels.max()) + 1):
        idx = np.flatnonzero(labels == c)
        if idx.size == 0:
            continue
        # nms_bev wants candidates pre-sorted by descending score
        o = idx[np.argsort(-scores[idx], kind="stable")]
        b5 = torch.from_numpy(boxes[o][:, [0, 1, 3, 4, 6]]).to(device)
        sc = torch.from_numpy(scores[o]).to(device)
        valid = torch.ones(o.size, dtype=torch.bool, device=device)
        mask = nms_bev(b5, sc, valid, nms_thr, o.size).cpu().numpy()
        keep_parts.append(o[mask])
    keep = np.concatenate(keep_parts)
    order = keep[np.argsort(-scores[keep], kind="stable")]
    order = order[:min(max_num, n_total)]
    return dict(boxes=boxes[order], scores=scores[order],
                labels=labels[order])
