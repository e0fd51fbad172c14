"""Waymo Open Dataset detection metrics (AP / APH, LEVEL_1 / LEVEL_2).

The port's copy of ``geomae_tpu/eval/waymo_eval.py`` (numpy only).

Numpy implementation of the protocol behind the reference's shelled-out
Waymo metrics binary (``mmdet3d/datasets/waymo_dataset.py:
305-309`` runs ``compute_detection_metrics_main``), in place of the KITTI
AP_R40 protocol.

Protocol (Waymo Open Dataset paper + metrics source semantics):

* classes with 3D-IoU match thresholds: Vehicle 0.7, Pedestrian 0.5,
  Cyclist 0.5, Sign 0.5;
* difficulty: LEVEL_1 = GTs with > 5 lidar points (unless annotated
  harder), LEVEL_2 = GTs with >= 1 point (a superset of L1).  In the L1
  breakdown, L2-only GTs are matchable-but-ignored (a detection matched
  to one is dropped from scoring, like the devkit's ignored handling);
* AP: area under the precision envelope over recall (continuous
  integration over every distinct score cutoff);
* APH: same, but each true positive contributes with heading accuracy
  weight ``1 - wrap(|yaw_pred - yaw_gt|)/pi`` (wrap into [0, pi]) in BOTH
  precision and recall numerators.

Documented deviations from the official binary: matching is greedy in
score order (highest-IoU unmatched GT first) instead of per-frame
Hungarian; the official binary's per-breakdown score cutoffs sample the
PR curve at a fixed grid, here it is integrated exactly.  Both choices
shift AP by well under a point for detector-scale result sets.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .kitti_eval import _iou3d

CLASSES = ("Vehicle", "Pedestrian", "Cyclist", "Sign")
# "Car" aliases Vehicle for KITTI-format Waymo infos (data/waymo.py)
IOU_THRESHOLDS = {"Vehicle": 0.7, "Car": 0.7, "Pedestrian": 0.5,
                  "Cyclist": 0.5, "Sign": 0.5}
L1_MIN_POINTS = 6          # LEVEL_1: strictly more than 5 points


def _wrap_heading(d: np.ndarray) -> np.ndarray:
    """Absolute heading difference wrapped into [0, pi]."""
    d = np.abs(d) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _ap_from_matches(scores, tp_w, is_tp, n_gt):
    """(AP, APH-style weighted AP) via the precision-envelope area.

    scores/is_tp/tp_w: per-prediction arrays (tp_w is the heading weight,
    0 for FPs); n_gt: number of counted GTs."""
    if n_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    w = tp_w[order]
    cum_w = np.cumsum(w)
    ranks = np.arange(1, len(w) + 1)
    prec = cum_w / ranks
    rec = cum_w / n_gt
    # envelope: max precision at recall >= r; integrate over recall deltas
    env = np.maximum.accumulate(prec[::-1])[::-1]
    drec = np.diff(np.concatenate([[0.0], rec]))
    return float(np.sum(env * drec))


def _gt_levels(gt: Dict, cls: str):
    """(count_l1, count_l2, ignored_for_l1, outside) boolean masks."""
    names = np.asarray(gt["names"])
    n = len(names)
    is_cls = names == cls
    npts = np.asarray(gt.get("num_points", np.full(n, L1_MIN_POINTS)))
    # annotated difficulty overrides (2 forces LEVEL_2)
    forced_l2 = np.asarray(gt.get("difficulty", np.zeros(n))) >= 2
    l1 = is_cls & (npts >= L1_MIN_POINTS) & ~forced_l2
    l2 = is_cls & (npts >= 1)
    return l1, l2


def evaluate_waymo(predictions: List[Dict], ground_truths: List[Dict],
                   classes: Sequence[str] = CLASSES) -> Dict[str, float]:
    """Waymo AP/APH per class x level.

    predictions[i]: {'boxes' [N, 7] lidar (x y z_bottom dx dy dz yaw),
                     'scores' [N], 'names' [N] str}
    ground_truths[i]: {'boxes' [M, 7], 'names' [M] str, and optionally
                      'num_points' [M], 'difficulty' [M]}
    """
    out = {}
    for cls in classes:
        thr = IOU_THRESHOLDS.get(cls, 0.5)
        acc = {lvl: dict(scores=[], tp=[], hw=[], n_gt=0)
               for lvl in ("L1", "L2")}
        for pred, gt in zip(predictions, ground_truths):
            l1, l2 = _gt_levels(gt, cls)
            pm = np.asarray(pred["names"]) == cls
            pb = np.asarray(pred["boxes"])[pm]
            sc = np.asarray(pred["scores"])[pm]
            gb = np.asarray(gt["boxes"])
            iou = _iou3d(pb, gb) if len(pb) and len(gb) else \
                np.zeros((len(pb), len(gb)))
            for lvl, care in (("L1", l1), ("L2", l2)):
                a = acc[lvl]
                a["n_gt"] += int(care.sum())
                # ignorable = class GTs outside this level (L2-only in L1)
                ignore = l2 & ~care
                taken = np.zeros(len(gb), bool)
                for i in np.argsort(-sc, kind="stable"):
                    cand = iou[i] * (~taken)
                    cc = np.where(care, cand, 0.0)
                    j = int(np.argmax(cc)) if len(gb) else -1
                    if j >= 0 and cc[j] >= thr:
                        taken[j] = True
                        dh = _wrap_heading(pb[i, 6] - gb[j, 6])
                        a["scores"].append(sc[i])
                        a["tp"].append(True)
                        a["hw"].append(max(0.0, 1.0 - dh / np.pi))
                        continue
                    ic = np.where(ignore, cand, 0.0)
                    j = int(np.argmax(ic)) if len(gb) else -1
                    if j >= 0 and ic[j] >= thr:
                        taken[j] = True          # matchable-but-ignored
                    else:
                        a["scores"].append(sc[i])
                        a["tp"].append(False)
                        a["hw"].append(0.0)
        for lvl in ("L1", "L2"):
            a = acc[lvl]
            scores = np.asarray(a["scores"], np.float64)
            tp = np.asarray(a["tp"], bool)
            hw = np.asarray(a["hw"], np.float64)
            out[f"AP_{cls}_{lvl}"] = _ap_from_matches(
                scores, tp.astype(np.float64), tp, a["n_gt"])
            out[f"APH_{cls}_{lvl}"] = _ap_from_matches(
                scores, hw, tp, a["n_gt"])
    for lvl in ("L1", "L2"):
        for m in ("AP", "APH"):
            keys = [f"{m}_{c}_{lvl}" for c in classes
                    if f"{m}_{c}_{lvl}" in out]
            out[f"m{m}_{lvl}"] = float(np.mean([out[k] for k in keys]))
    return out
