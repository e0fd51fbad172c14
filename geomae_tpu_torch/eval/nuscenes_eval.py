"""nuScenes detection metrics (mAP / TP errors / NDS) in pure numpy.

The port's copy of ``geomae_tpu/eval/nuscenes_eval.py`` (numpy only).

The reference formats predictions to JSON and shells out to the
nuscenes-devkit (``mmdet3d/datasets/nuscenes_dataset.py:
367-514``).  The devkit isn't available here, so this module implements the
published protocol directly (it is fully specified by the nuScenes paper /
devkit docs):

* matching by BEV center distance at thresholds {0.5, 1, 2, 4} m,
  greedy over predictions sorted by score, one match per GT;
* AP = normalized area under the precision-recall curve restricted to
  recall, precision > 0.1;
* TP errors (ATE translation, ASE 1-IoU_aligned scale, AOE orientation,
  AVE velocity, AAE 1-attribute-accuracy) averaged over matches at the 2 m
  threshold, accumulated over the recall range above 10%;
* mATE etc. averaged over classes (devkit nanmean — traffic_cone skips
  attr/vel/orient, barrier skips attr/vel);
* NDS = (5*mAP + sum over the 5 TP errors of max(1 - min(1, err), 0))/10.

Predicted attributes follow the reference's velocity/class rule
(``mmdet3d/datasets/nuscenes_dataset.py:322-342``): speed
> 0.2 m/s => vehicle.moving / cycle.with_rider, else pedestrian.standing /
vehicle.stopped / the per-class default.  GT attributes are optional; when
absent the AAE term contributes 0 to NDS (AAE = 1), exactly what the
devkit scores for an attribute-free submission.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# devkit class ranges (detection_cvpr_2019.json): max center distance per class
CLASS_RANGES = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}

# reference per-class fallback attribute (nuscenes_dataset.py:69-80)
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider", "barrier": "", "traffic_cone": "",
}

# devkit: metrics not defined for a class are excluded from their mean
TP_SKIP = {
    "traffic_cone": ("attr_err", "vel_err", "orient_err"),
    "barrier": ("attr_err", "vel_err"),
}

TP_NAMES = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


def velocity_attribute(name: str, vx: float, vy: float) -> str:
    """Reference attribute rule (nuscenes_dataset.py:322-342): moving
    vehicles -> vehicle.moving, moving cycles -> cycle.with_rider; parked
    pedestrians -> pedestrian.standing, stopped buses -> vehicle.stopped;
    everything else the per-class default."""
    if float(np.hypot(vx, vy)) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck",
                    "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE.get(name, "")
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(name, "")


def _yaw_diff(a, b, period=2 * np.pi):
    """Devkit ``angle_diff``: barrier orientation scores with period pi
    (eval/detection/algo.py), every other class 2*pi."""
    d = np.abs(a - b) % period
    return np.minimum(d, period - d)


def _aligned_iou3d(box_a, box_b):
    """Scale error helper: IoU of yaw-aligned, co-centered boxes."""
    inter = np.prod(np.minimum(box_a[3:6], box_b[3:6]))
    union = np.prod(box_a[3:6]) + np.prod(box_b[3:6]) - inter
    return inter / max(union, 1e-8)


N_ELEM = 101   # devkit DetectionMetricData.nelem


def accumulate_class(preds: List[Dict], gts: List[Dict], dist_th: float,
                     period: float = 2 * np.pi):
    """One (class, threshold) accumulation over all frames, mirroring the
    devkit's ``accumulate`` + ``calc_ap`` + ``calc_tp`` step by step
    (nuscenes-devkit eval/detection/algo.py, reimplemented from the
    published algorithm):

    * greedy matching in descending-score order; closest unmatched GT of
      the frame by BEV center distance;
    * precision/confidence interpolated onto 101 recall points
      (``right=0`` beyond the max achieved recall, flat extension on the
      left — both devkit quirks);
    * TP errors: cumulative means over MATCHED predictions only,
      interpolated on CONFIDENCE (not recall), then averaged over recall
      indices 11..max_recall_ind (strictly above 10% recall);
    * AP = mean over recall indices 11..100 of (prec - 0.1 clipped at 0)
      / 0.9.
    """
    n_gt = sum(len(g["boxes"]) for g in gts)
    # (score, is_tp, trans_err, scale_err, orient_err, vel_err, attr_err);
    # attr_err is nan when GT carries no attribute (devkit attr_acc)
    rows = []
    for pred, gt in zip(preds, gts):
        pb, sc = pred["boxes"], pred["scores"]
        gb = gt["boxes"]
        p_attr = pred.get("attrs")
        g_attr = gt.get("attrs")
        taken = np.zeros(len(gb), bool)
        order = np.argsort(-sc)
        for i in order:
            if len(gb) == 0:
                rows.append((sc[i], 0, 0, 0, 0, 0, np.nan))
                continue
            d = np.linalg.norm(gb[:, :2] - pb[i, :2], axis=1)
            d = np.where(taken, np.inf, d)
            j = int(np.argmin(d))
            if d[j] < dist_th:
                taken[j] = True
                te = d[j]
                se = 1.0 - _aligned_iou3d(pb[i], gb[j])
                oe = _yaw_diff(pb[i, 6], gb[j, 6], period)
                ve = float(np.linalg.norm(pb[i, 7:9] - gb[j, 7:9])) \
                    if pb.shape[1] > 7 and gb.shape[1] > 7 else 0.0
                ae = np.nan
                if p_attr is not None and g_attr is not None \
                        and g_attr[j] != "":
                    ae = 0.0 if p_attr[i] == g_attr[j] else 1.0
                rows.append((sc[i], 1, te, se, oe, ve, ae))
            else:
                rows.append((sc[i], 0, 0, 0, 0, 0, np.nan))

    if n_gt == 0 or not rows:
        return None
    rows = np.asarray(sorted(rows, key=lambda r: -r[0]), np.float64)
    tp = np.cumsum(rows[:, 1])
    fp = np.cumsum(1 - rows[:, 1])
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / n_gt
    conf = rows[:, 0]

    rec_interp = np.linspace(0, 1, N_ELEM)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    first_ind = round(100 * MIN_RECALL) + 1              # 11: strictly >10%
    nz = np.nonzero(conf_i)[0]
    max_recall_ind = int(nz.max()) if len(nz) else 0

    is_tp = rows[:, 1] > 0
    out = dict()
    if is_tp.any() and max_recall_ind >= first_ind:
        tp_conf = conf[is_tp]
        # devkit cummean: nan entries (GT without attribute) don't advance
        # the running mean; a nan prefix reads 0, an all-nan column reads 1
        vals = rows[is_tp, 2:7]
        seen = ~np.isnan(vals)
        cnt = np.cumsum(seen, axis=0)
        cummean = np.nancumsum(np.where(seen, vals, 0.0), axis=0) \
            / np.maximum(cnt, 1)
        cummean = np.where(cnt > 0, cummean, 0.0)
        all_nan = ~seen.any(axis=0)
        cummean[:, all_nan] = 1.0
        for k, name in enumerate(TP_NAMES):
            # devkit: interpolate the cumulative mean on confidence
            # (both sequences reversed so x is increasing)
            v = np.interp(conf_i[::-1], tp_conf[::-1],
                          cummean[::-1, k])[::-1]
            out[name] = float(v[first_ind:max_recall_ind + 1].mean())
    else:
        out = {name: 1.0 for name in TP_NAMES}

    p = np.clip(prec_i[first_ind:] - MIN_PRECISION, 0, None)
    out["ap"] = float(p.mean() / (1 - MIN_PRECISION))
    return out


def evaluate(predictions: List[Dict], ground_truths: List[Dict],
             class_names: Sequence[str]) -> Dict[str, float]:
    """Full protocol over frames.

    predictions[i]: {'boxes' [N, 9], 'scores' [N], 'labels' [N]}
    ground_truths[i]: {'boxes' [M, 9], 'labels' [M],
                       optional 'attrs' [M] attribute-name strings}
    Predicted attributes are derived from each box's velocity and class by
    the reference rule (``velocity_attribute``), matching what
    ``format_results_json`` submits to the devkit.
    """
    ap_per_class = {}
    tp_per_class = {}
    has_attrs = any("attrs" in g for g in ground_truths)
    for ci, cname in enumerate(class_names):
        rng = CLASS_RANGES.get(cname, 50.0)

        def _filt(frame, is_pred):
            b = frame["boxes"]
            m = (frame["labels"] == ci) & (
                np.linalg.norm(b[:, :2], axis=1) < rng)
            out = {"boxes": b[m]}
            if is_pred:
                out["scores"] = frame["scores"][m]
                if has_attrs and b.shape[1] > 7:
                    out["attrs"] = [velocity_attribute(cname, x[7], x[8])
                                    for x in b[m]]
            elif "attrs" in frame:
                out["attrs"] = [frame["attrs"][i]
                                for i in np.flatnonzero(m)]
            return out

        preds = [_filt(f, True) for f in predictions]
        gts = [_filt(f, False) for f in ground_truths]
        aps, tps = [], None
        for th in DIST_THRESHOLDS:
            acc = accumulate_class(
                preds, gts, th,
                period=np.pi if cname == "barrier" else 2 * np.pi)
            if acc is None:
                continue
            aps.append(acc["ap"])
            if th == TP_THRESHOLD:
                tps = acc
        if aps:
            ap_per_class[cname] = float(np.mean(aps))
            tp_per_class[cname] = tps

    if not ap_per_class:
        return dict(mAP=0.0, NDS=0.0)
    mAP = float(np.mean(list(ap_per_class.values())))
    errs = {}
    for name in TP_NAMES:
        if name == "attr_err" and not has_attrs:
            # no GT attributes available: the devkit scores an
            # attribute-free submission AAE = 1 (NDS term 0)
            errs["mattr_err"] = 1.0
            continue
        # devkit nanmean over classes, skipping classes for which the
        # metric is undefined (TP_SKIP)
        vals = [t[name] for c, t in tp_per_class.items()
                if t is not None and name not in TP_SKIP.get(c, ())]
        errs["m" + name] = float(np.mean(vals)) if vals else 1.0
    tp_score = sum(max(1 - min(e, 1.0), 0.0) for e in errs.values())
    nds = (5 * mAP + tp_score) / 10.0
    out = dict(mAP=mAP, NDS=nds, **errs)
    for c, v in ap_per_class.items():
        out[f"AP_{c}"] = v
    return out


def format_results_json(tokens: List[str], predictions: List[Dict],
                        class_names: Sequence[str]) -> Dict:
    """nuScenes submission JSON (devkit-compatible), for use with the
    official evaluator when available (reference ``nuscenes_dataset.py:
    298-366`` behavior, global frame conversion left to the caller)."""
    results = {}
    for tok, pred in zip(tokens, predictions):
        frame = []
        for b, s, l in zip(pred["boxes"], pred["scores"], pred["labels"]):
            name = class_names[int(l)]
            frame.append(dict(
                sample_token=tok,
                translation=[float(b[0]), float(b[1]),
                             float(b[2] + b[5] / 2)],
                size=[float(b[4]), float(b[3]), float(b[5])],  # wlh order
                rotation=_yaw_to_quat(float(b[6])),
                velocity=[float(b[7]), float(b[8])],
                detection_name=name,
                detection_score=float(s),
                attribute_name=velocity_attribute(
                    name, float(b[7]), float(b[8])),
            ))
        results[tok] = frame
    return dict(meta=dict(use_camera=False, use_lidar=True, use_radar=False,
                          use_map=False, use_external=False),
                results=results)


def _yaw_to_quat(yaw: float):
    # nuScenes boxes rotate about +z; devkit quaternion (w, x, y, z).
    # mmdet3d converts lidar yaw to global with -yaw - pi/2; that transform
    # belongs to the ego->global step, not here.
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]
