"""Detection serving API: ``Detector3D``, ``init_model``,
``inference_detector``.

Port of ``geomae_tpu/apis.py`` with the predict function of
``geomae_tpu/train/finetune.py:make_predict_fn`` (anchor head, greedy
NMS).  One request is one raw point cloud; it is range-filtered and
padded to the static point cap, voxelized, and run through the model and
``predict`` on ``device``.  On a CUDA device the model's segment,
attention and post-attention steps run the port's CUDA kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import config as C
# re-exported so callers of the serving API need no other module
from .config import geomae_finetune_nus, replace  # noqa: F401
from .data.transforms import pad_points, points_range_filter
from .models.anchor_head import Detections, predict
from .models.anchors import grid_anchors, head_featmap_size
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
        self.anchors = torch.from_numpy(grid_anchors(
            self.cfg.head, head_featmap_size(self.cfg))).to(self.device)

    @torch.no_grad()
    def predict(self, points: torch.Tensor,
                point_valid: torch.Tensor) -> Detections:
        """points [B, P, 5], point_valid [B, P] on ``self.device``."""
        scene = extract_scene(self.cfg, points, point_valid)
        return predict(self.model(scene), self.anchors, self.cfg.head)

    def __call__(self, points: np.ndarray) -> Dict[str, np.ndarray]:
        """points [N, 5] (x y z intensity dt) -> boxes [M, 9], scores [M],
        labels [M] as numpy arrays."""
        det = self.predict(*to_batch(self.cfg, points, self.device))
        m = det.valid[0].cpu().numpy()
        return dict(boxes=det.boxes[0].cpu().numpy()[m],
                    scores=det.scores[0].cpu().numpy()[m],
                    labels=det.labels[0].cpu().numpy()[m])


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
