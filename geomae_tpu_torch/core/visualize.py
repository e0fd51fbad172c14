"""Detection visualizer: point-cloud / box dumps for debugging.

The port's copy of ``geomae_tpu/core/visualize.py``.  Fills the
``show_result`` role of the reference
(``mmdet3d/core/visualizer/show_result.py:74-124``:
write the points as .obj, GT boxes as ``*_gt.obj``, predictions as
``*_pred.obj``).  Dependency-free re-design: boxes are written as OBJ
wireframes (8 corners + 12 ``l`` line elements) instead of trimesh solids,
which every OBJ viewer renders and diffs cleanly; an optional BEV PNG
(matplotlib, gated) shows points + rotated box outlines + scores top-down.

Box layout everywhere: [x, y, z_bottom, dx, dy, dz, yaw, (vx, vy, ...)].
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),       # bottom ring
          (4, 5), (5, 6), (6, 7), (7, 4),       # top ring
          (0, 4), (1, 5), (2, 6), (3, 7)]       # verticals


def box_corners(boxes: np.ndarray) -> np.ndarray:
    """8 corners per box, [N, 8, 3].  Bottom-origin boxes; corners 0-3 are
    the bottom ring (counter-clockwise), 4-7 the top ring above them."""
    boxes = np.asarray(boxes, np.float64)
    n = boxes.shape[0]
    dx, dy, dz = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    sx = np.array([0.5, 0.5, -0.5, -0.5])
    sy = np.array([-0.5, 0.5, 0.5, -0.5])
    cx = sx[None, :] * dx[:, None]                      # [N, 4]
    cy = sy[None, :] * dy[:, None]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    rx = c * cx - s * cy + boxes[:, 0:1]
    ry = s * cx + c * cy + boxes[:, 1:2]
    out = np.zeros((n, 8, 3))
    for ring, zoff in ((slice(0, 4), 0.0), (slice(4, 8), 1.0)):
        out[:, ring, 0] = rx
        out[:, ring, 1] = ry
        out[:, ring, 2] = (boxes[:, 2] + zoff * dz)[:, None]
    return out


def write_points_obj(points: np.ndarray, path: str) -> None:
    """Points as OBJ vertices (reference ``_write_obj``)."""
    pts = np.asarray(points)
    with open(path, "w") as f:
        for p in pts:
            f.write(f"v {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def write_boxes_obj(boxes: np.ndarray, path: str) -> None:
    """Boxes as OBJ wireframes (the ``_write_oriented_bbox`` analogue)."""
    corners = box_corners(np.asarray(boxes).reshape(-1, boxes.shape[-1]))
    with open(path, "w") as f:
        for bi, cs in enumerate(corners):
            for c in cs:
                f.write(f"v {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            base = bi * 8 + 1                     # OBJ indices are 1-based
            for a, b in _EDGES:
                f.write(f"l {base + a} {base + b}\n")


def show_result(points: Optional[np.ndarray],
                gt_boxes: Optional[np.ndarray],
                pred_boxes: Optional[np.ndarray],
                out_dir: str,
                filename: str,
                scores: Optional[np.ndarray] = None,
                labels: Optional[np.ndarray] = None,
                bev_png: bool = True) -> dict:
    """Dump one frame; returns {kind: path} of everything written
    (mirrors the reference ``show_result`` contract: ``<out_dir>/
    <filename>/<filename>_{points,gt,pred}.obj`` + optional BEV PNG)."""
    result_dir = os.path.join(out_dir, filename)
    os.makedirs(result_dir, exist_ok=True)
    written = {}
    if points is not None:
        p = os.path.join(result_dir, f"{filename}_points.obj")
        write_points_obj(points, p)
        written["points"] = p
    if gt_boxes is not None and len(gt_boxes):
        p = os.path.join(result_dir, f"{filename}_gt.obj")
        write_boxes_obj(gt_boxes, p)
        written["gt"] = p
    if pred_boxes is not None and len(pred_boxes):
        p = os.path.join(result_dir, f"{filename}_pred.obj")
        write_boxes_obj(pred_boxes, p)
        written["pred"] = p
    if bev_png:
        p = os.path.join(result_dir, f"{filename}_bev.png")
        if _bev_png(points, gt_boxes, pred_boxes, scores, p):
            written["bev"] = p
    return written


def _bev_png(points, gt_boxes, pred_boxes, scores, path) -> bool:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(10, 10))
    if points is not None and len(points):
        pts = np.asarray(points)
        ax.scatter(pts[:, 0], pts[:, 1], s=0.3, c="0.6", linewidths=0)

    def draw(boxes, color, scs=None):
        ring = box_corners(np.asarray(boxes))[:, :4, :2]
        for i, r in enumerate(ring):
            ax.plot(np.append(r[:, 0], r[0, 0]),
                    np.append(r[:, 1], r[0, 1]), color=color, lw=1.0)
            if scs is not None:
                ax.annotate(f"{float(scs[i]):.2f}", r.mean(0),
                            fontsize=6, color=color)

    if gt_boxes is not None and len(gt_boxes):
        draw(gt_boxes, "tab:green")
    if pred_boxes is not None and len(pred_boxes):
        draw(pred_boxes, "tab:red", scores)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def _numpy(a) -> np.ndarray:
    """An array or a tensor on any device as a numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def show_results_batch(detections, out_dir: str,
                       names: Sequence[str],
                       points_batch=None, gt_batch=None,
                       score_thr: float = 0.3) -> list:
    """Dump N frames from batched fixed-size Detections (the tool entry;
    drives ``show_result`` like the reference's test-time ``--show-dir``)."""
    out = []
    boxes, scores, valid = (_numpy(t) for t in (
        detections.boxes, detections.scores, detections.valid))
    for i, name in enumerate(names):
        sel = valid[i] & (scores[i] >= score_thr)
        out.append(show_result(
            None if points_batch is None else _numpy(points_batch[i]),
            None if gt_batch is None else _numpy(gt_batch[i]),
            boxes[i][sel], out_dir, name, scores=scores[i][sel]))
    return out
