"""KITTI 3D detection metrics (AP_R40 for bbox-less LiDAR evaluation).

The port's copy of ``geomae_tpu/eval/kitti_eval.py``, with the port's
rotated IoU (``ops/rotated_iou.py``) on CPU tensors.  A numpy rebuild of
the metric core of ``kitti_eval``
(``mmdet3d/core/evaluation/kitti_utils/eval.py``, itself a port of the
official KITTI C++ devkit):

* per-class, per-difficulty AP with the official difficulty gates
  (easy/moderate/hard via 2D box height, occlusion, truncation);
* matching by BEV or 3D rotated IoU at the official thresholds
  (0.7 car, 0.5 pedestrian/cyclist), greedy over score order;
* AP_R40: mean over the 40 recall sample points r = 1/40..1 of the
  interpolated precision ``max_{rec >= r} prec(rec)``.

Deviation from the C++ devkit (documented): the devkit evaluates
precision at 41 sampled score thresholds derived from the GT count; this
implementation evaluates the exact precision envelope at every rank and
samples the same 40 recall positions — equal up to the devkit's score
discretization.  "DontCare"/ignored-GT handling follows the devkit:
ignored GTs (wrong difficulty but right class) neither count as GT nor
penalize matched predictions.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

CLASSES = ("Car", "Pedestrian", "Cyclist")
IOU_THRESHOLDS = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# official difficulty gates: max truncation, max occlusion, min 2D height
DIFFICULTY = (
    (0.15, 0, 40.0),     # easy
    (0.30, 1, 25.0),     # moderate
    (0.50, 2, 25.0),     # hard
)


def _bev_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Rotated BEV IoU [Na, Nb] through the port's polygon clipper, on the
    CPU."""
    import torch

    from ..ops.rotated_iou import boxes_iou_bev
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    a5 = torch.from_numpy(np.asarray(boxes_a[:, [0, 1, 3, 4, 6]], np.float32))
    b5 = torch.from_numpy(np.asarray(boxes_b[:, [0, 1, 3, 4, 6]], np.float32))
    return boxes_iou_bev(a5, b5).numpy()


def _iou3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """3D IoU: BEV intersection x z-overlap / union (z is box BOTTOM)."""
    bev = _bev_iou(boxes_a, boxes_b)
    if bev.size == 0:
        return bev
    a_area = boxes_a[:, 3] * boxes_a[:, 4]
    b_area = boxes_b[:, 3] * boxes_b[:, 4]
    inter_bev = bev * (a_area[:, None] + b_area[None, :]) / (1.0 + bev)
    za0, za1 = boxes_a[:, 2], boxes_a[:, 2] + boxes_a[:, 5]
    zb0, zb1 = boxes_b[:, 2], boxes_b[:, 2] + boxes_b[:, 5]
    dz = np.clip(np.minimum(za1[:, None], zb1[None, :])
                 - np.maximum(za0[:, None], zb0[None, :]), 0, None)
    inter = inter_bev * dz
    vol_a = a_area * boxes_a[:, 5]
    vol_b = b_area * boxes_b[:, 5]
    return inter / np.maximum(vol_a[:, None] + vol_b[None, :] - inter, 1e-8)


def _gt_care_masks(gt: Dict, cls: str, difficulty: int):
    """(care, ignore): GTs counted as targets vs class-matching but
    difficulty-failing (neither counted nor penalized)."""
    names = np.asarray(gt["names"])
    n = len(names)
    is_cls = names == cls
    # Van counts as ignored for Car, Person_sitting for Pedestrian (devkit)
    similar = {"Car": "Van", "Pedestrian": "Person_sitting"}.get(cls)
    is_similar = names == similar if similar else np.zeros(n, bool)
    trunc = np.asarray(gt.get("truncated", np.zeros(n)))
    occ = np.asarray(gt.get("occluded", np.zeros(n, np.int64)))
    hmin = np.asarray(gt.get("bbox_height", np.full(n, np.inf)))
    max_tr, max_occ, min_h = DIFFICULTY[difficulty]
    # devkit clean_data ignores at ``height <= MIN_HEIGHT`` (strict pass
    # requires > min_h; reference eval.py:53-55)
    passes = (trunc <= max_tr) & (occ <= max_occ) & (hmin > min_h)
    care = is_cls & passes
    ignore = (is_cls & ~passes) | is_similar
    return care, ignore


def ap_r40(scores: np.ndarray, is_tp: np.ndarray, n_gt: int) -> float:
    """AP over 40 recall samples of the interpolated precision."""
    if n_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = np.cumsum(is_tp[order])
    fp = np.cumsum(~is_tp[order])
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / n_gt
    # precision envelope: max precision at recall >= r
    env = np.maximum.accumulate(prec[::-1])[::-1]
    rs = np.arange(1, 41) / 40.0
    idx = np.searchsorted(rec, rs, side="left")
    vals = np.where(idx < len(rec), env[np.minimum(idx, len(rec) - 1)], 0.0)
    return float(vals.mean())


# ---------------------------------------------------------------------------
# exact reference protocol (11-point AP over 41 sampled thresholds)
# ---------------------------------------------------------------------------

_NO_DET = -10000000.0


def _ref_thresholds(scores: np.ndarray, num_gt: int,
                    num_sample_pts: int = 41) -> List[float]:
    """Score thresholds at ~1/40 recall steps (``get_thresholds``,
    reference ``kitti_utils/eval.py:8-26``)."""
    scores = np.sort(np.asarray(scores))[::-1]
    current_recall = 0.0
    thresholds: List[float] = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(float(score))
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def _det_states(pred: Dict, cls: str, difficulty: int) -> np.ndarray:
    """Detection states per ``clean_data`` (``eval.py:68-79``): 1 =
    ignored (2D box below the difficulty's min height — regardless of
    class), 0 = counted (right class), -1 = skipped."""
    names = np.asarray(pred["names"])
    n = len(names)
    h = np.asarray(pred.get("bbox_height", np.full(n, np.inf)))
    min_h = DIFFICULTY[difficulty][2]
    return np.where(h < min_h, 1, np.where(names == cls, 0, -1))


def _stats_frame(iou: np.ndarray, scores: np.ndarray, gt_state: np.ndarray,
                 det_state: np.ndarray, min_overlap: float, thresh: float,
                 compute_fp: bool):
    """Per-frame matching statistics (``compute_statistics_jit``,
    ``eval.py:162-280``; metric >= 1 so DontCare 2D boxes never apply).

    gt_state / det_state: 0 counted, 1 ignored, -1 skipped.
    Returns (tp, fp, fn, tp_scores)."""
    D, G = iou.shape
    assigned = np.zeros(D, bool)
    ignored_thr = (scores < thresh) if compute_fp else np.zeros(D, bool)
    tp = fp = fn = 0
    tp_scores: List[float] = []
    for i in range(G):
        if gt_state[i] == -1:
            continue
        det_idx, valid = -1, _NO_DET
        max_ov, assigned_ig = 0.0, False
        for j in range(D):
            if det_state[j] == -1 or assigned[j] or ignored_thr[j]:
                continue
            ov = iou[j, i]
            if not compute_fp and ov > min_overlap and scores[j] > valid:
                det_idx, valid = j, scores[j]
            elif (compute_fp and ov > min_overlap
                  and (ov > max_ov or assigned_ig) and det_state[j] == 0):
                max_ov, det_idx, valid, assigned_ig = ov, j, 1.0, False
            elif (compute_fp and ov > min_overlap and valid == _NO_DET
                  and det_state[j] == 1):
                det_idx, valid, assigned_ig = j, 1.0, True
        if valid == _NO_DET and gt_state[i] == 0:
            fn += 1
        elif valid != _NO_DET and (gt_state[i] == 1
                                   or det_state[det_idx] == 1):
            assigned[det_idx] = True
        elif valid != _NO_DET:
            tp += 1
            tp_scores.append(float(scores[det_idx]))
            assigned[det_idx] = True
    if compute_fp:
        fp = int(np.sum(~assigned & (det_state == 0) & ~ignored_thr))
    return tp, fp, fn, tp_scores


def evaluate_kitti_ap11(predictions: List[Dict], ground_truths: List[Dict],
                        classes: Sequence[str] = CLASSES,
                        metric: str = "3d") -> Dict[str, float]:
    """EXACT reference protocol: 11-point interpolated AP over 41 score
    thresholds sampled at ~1/40 recall steps (``eval_class`` +
    ``get_mAP``, reference ``kitti_utils/eval.py:450-576``) — the number
    the reference's ``kitti_eval`` prints (scaled here to [0, 1], the
    reference multiplies by 100).  Golden-diffed against the extracted
    reference code in ``tests/test_kitti_eval_golden.py``.

    Same input schema as :func:`evaluate_kitti`; predictions may carry
    ``bbox_height`` for the devkit's low-detection ignore rule."""
    iou_fn = _iou3d if metric == "3d" else _bev_iou
    out: Dict[str, float] = {}
    for cls in classes:
        min_ov = IOU_THRESHOLDS.get(cls, 0.5)
        for d, dname in enumerate(("easy", "moderate", "hard")):
            frames = []
            n_gt = 0
            all_tp_scores: List[float] = []
            for pred, gt in zip(predictions, ground_truths):
                care, ignore = _gt_care_masks(gt, cls, d)
                gt_state = np.where(care, 0, np.where(ignore, 1, -1))
                det_state = _det_states(pred, cls, d)
                pb = np.asarray(pred["boxes"]).reshape(-1, 7)
                gb = np.asarray(gt["boxes"]).reshape(-1, 7)
                sc = np.asarray(pred["scores"], np.float64)
                iou = iou_fn(pb, gb) if len(pb) and len(gb) else \
                    np.zeros((len(pb), len(gb)))
                iou = np.asarray(iou, np.float64)
                n_gt += int(care.sum())
                _, _, _, tps = _stats_frame(iou, sc, gt_state, det_state,
                                            min_ov, 0.0, compute_fp=False)
                all_tp_scores += tps
                frames.append((iou, sc, gt_state, det_state))
            thresholds = _ref_thresholds(np.asarray(all_tp_scores),
                                         max(n_gt, 1))
            prec = np.zeros(41)
            for t, thr in enumerate(thresholds):
                tp = fp = 0
                for iou, sc, gs, ds in frames:
                    tpi, fpi, _, _ = _stats_frame(iou, sc, gs, ds, min_ov,
                                                  thr, compute_fp=True)
                    tp += tpi
                    fp += fpi
                prec[t] = tp / max(tp + fp, 1)
            # precision envelope then 11-point sampling (eval.py:556-576)
            prec = np.maximum.accumulate(prec[::-1])[::-1]
            out[f"AP11_{metric}_{cls}_{dname}"] = float(
                prec[0::4].sum() / 11.0)
    keys = [k for k in out if "_moderate" in k]
    out[f"mAP11_{metric}_moderate"] = float(np.mean([out[k] for k in keys]))
    return out


def evaluate_kitti(predictions: List[Dict], ground_truths: List[Dict],
                   classes: Sequence[str] = CLASSES,
                   metric: str = "3d") -> Dict[str, float]:
    """KITTI AP_R40 per class x difficulty.

    predictions[i]: {'boxes' [N, 7] lidar (x y z_bottom dx dy dz yaw),
                     'scores' [N], 'names' [N] str}
    ground_truths[i]: {'boxes' [M, 7], 'names' [M] str, and optionally
                      'truncated', 'occluded', 'bbox_height'}
    metric: 'bev' or '3d'.
    """
    iou_fn = _iou3d if metric == "3d" else _bev_iou
    out = {}
    for cls in classes:
        thr = IOU_THRESHOLDS.get(cls, 0.5)
        for d, dname in enumerate(("easy", "moderate", "hard")):
            all_scores, all_tp = [], []
            n_gt = 0
            for pred, gt in zip(predictions, ground_truths):
                care, ignore = _gt_care_masks(gt, cls, d)
                n_gt += int(care.sum())
                pm = np.asarray(pred["names"]) == cls
                pb = np.asarray(pred["boxes"])[pm]
                sc = np.asarray(pred["scores"])[pm]
                gb = np.asarray(gt["boxes"])
                iou = iou_fn(pb, gb) if len(pb) and len(gb) else \
                    np.zeros((len(pb), len(gb)))
                taken = np.zeros(len(gb), bool)
                for i in np.argsort(-sc):
                    cand = iou[i] * (~taken)
                    # care GTs take priority: an ignored GT with higher IoU
                    # must not steal a prediction that also clears a care GT
                    # (devkit matches against counted GTs first)
                    cc = np.where(care, cand, 0.0)
                    j = int(np.argmax(cc)) if len(gb) else -1
                    if j >= 0 and cc[j] >= thr:
                        taken[j] = True
                        all_scores.append(sc[i])
                        all_tp.append(True)
                        continue
                    ic = np.where(ignore, cand, 0.0)
                    j = int(np.argmax(ic)) if len(gb) else -1
                    if j >= 0 and ic[j] >= thr:
                        taken[j] = True   # ignored GT match: drop silently
                    else:
                        all_scores.append(sc[i])
                        all_tp.append(False)
            out[f"AP_{metric}_{cls}_{dname}"] = ap_r40(
                np.asarray(all_scores), np.asarray(all_tp), n_gt)
    keys = [k for k in out if "_moderate" in k]
    out[f"mAP_{metric}_moderate"] = float(np.mean([out[k] for k in keys]))
    return out
