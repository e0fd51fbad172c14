"""Detection serving API: ``Detector3D``, ``init_model``,
``inference_detector``.

Port of ``geomae_tpu/apis.py`` with the predict function of
``geomae_tpu/train/finetune.py:make_predict_fn``: the anchor head's
greedy NMS per class, or the CenterHead's decode and NMS per task
(``cfg.head_type``).  One request is one raw point cloud; it is
range-filtered and padded to the static point cap, voxelized, and run
through the model and the decode on ``device``.  ``aug_test`` serves
flipped and scaled views of one cloud and merges their boxes
(``core/aug_merge.py``).  On a CUDA device the model's segment,
attention and post-attention steps run the port's CUDA kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import config as C
# re-exported so callers of the serving API need no other module
from .config import geomae_finetune_nus, replace  # noqa: F401
from .data.transforms import pad_points, points_range_filter
from .models.anchor_head import Detections, predict
from .models.anchors import grid_anchors, head_featmap_size
from .models.center_head import center_head_decode
from .models.detector import DynamicVoxelNet, extract_scene, init_weights
from .train.checkpoint import load_weights


class Detector3D:
    """Builds the model on ``device``, fills it from ``checkpoint`` (a
    file holding a reference-style ``state_dict``, optionally under a
    ``"state_dict"`` key, or a trainer checkpoint: its ``ckpt/`` directory
    or one step's file; ``train/checkpoint.load_weights``) or else from
    ``generator`` (default: seeded with ``cfg.seed``), and predicts."""

    def __init__(self, cfg: Optional[C.FinetuneConfig] = None,
                 checkpoint: Optional[str] = None,
                 device: torch.device | str = "cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg or C.geomae_finetune_nus()
        self.device = torch.device(device)
        model = DynamicVoxelNet(self.cfg, device="meta")
        self.model = model.to_empty(device=self.device)
        if checkpoint is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.cfg.seed)
            init_weights(self.model, generator)
        else:
            self.model.load_state_dict(
                load_weights(checkpoint, self.device), strict=True)
        self.model.eval()
        self.anchors = None if self.cfg.head_type == "center" else \
            torch.from_numpy(grid_anchors(
                self.cfg.head, head_featmap_size(self.cfg))).to(self.device)

    @torch.no_grad()
    def predict(self, points: torch.Tensor,
                point_valid: torch.Tensor) -> Detections:
        """points [B, P, 5], point_valid [B, P] on ``self.device``."""
        scene = extract_scene(self.cfg, points, point_valid)
        out = self.model(scene)
        if self.cfg.head_type == "center":
            return center_head_decode(out, self.cfg.center_head,
                                      self.cfg.voxel)
        return predict(out, self.anchors, self.cfg.head)

    def __call__(self, points: np.ndarray) -> Dict[str, np.ndarray]:
        """points [N, 5] (x y z intensity dt) -> boxes [M, 9], scores [M],
        labels [M] as numpy arrays."""
        det = self.predict(*to_batch(self.cfg, points, self.device))
        m = det.valid[0].cpu().numpy()
        return dict(boxes=det.boxes[0].cpu().numpy()[m],
                    scores=det.scores[0].cpu().numpy()[m],
                    labels=det.labels[0].cpu().numpy()[m])

    def aug_test(self, points: np.ndarray,
                 flips: Tuple[Tuple[bool, bool], ...] = (
                     (False, False), (True, False), (False, True),
                     (True, True)),
                 scales: Tuple[float, ...] = (1.0,)
                 ) -> Dict[str, np.ndarray]:
        """Test-time augmentation (the reference's ``VoxelNet.aug_test``):
        serve each flipped and scaled view of the cloud, map its boxes
        back, and merge the views by rotated NMS per class at
        ``cfg.head.nms_thr``, keeping the ``cfg.head.max_num`` best, as
        the JAX package does for either head, on the detector's device."""
        from .core.aug_merge import merge_aug_bboxes_3d

        results, metas = [], []
        for s in scales:
            for fh, fv in flips:
                pts = np.array(points, np.float32, copy=True)
                if fh:
                    pts[:, 1] = -pts[:, 1]
                if fv:
                    pts[:, 0] = -pts[:, 0]
                pts[:, :3] *= s
                results.append(self(pts))
                metas.append(dict(pcd_scale_factor=s,
                                  pcd_horizontal_flip=fh,
                                  pcd_vertical_flip=fv))
        return merge_aug_bboxes_3d(results, metas, self.cfg.head.nms_thr,
                                   self.cfg.head.max_num, self.device)


def to_batch(cfg: C.FinetuneConfig, points: np.ndarray,
             device: torch.device | str):
    """One raw cloud [N, 5] -> range-filtered, padded (points [1, P, 5],
    valid [1, P]) on ``device``."""
    s = points_range_filter(dict(points=points),
                            cfg.voxel.point_cloud_range)
    p, v = pad_points(s["points"], cfg.caps.max_points)
    return (torch.from_numpy(p[None]).to(device),
            torch.from_numpy(v[None]).to(device))


def init_model(checkpoint: Optional[str] = None,
               cfg: Optional[C.FinetuneConfig] = None,
               device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None) -> Detector3D:
    return Detector3D(cfg, checkpoint, device, generator)


def inference_detector(model: Detector3D,
                       points: np.ndarray) -> Dict[str, np.ndarray]:
    return model(points)
