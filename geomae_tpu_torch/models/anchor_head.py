"""Anchor3DHead and detection decoding (inference only).

Port of ``geomae_tpu/models/anchor_head.py`` (``Anchor3DHead``,
``Detections``, ``_nms_from_iou``, ``predict``): per sample, the top
``nms_pre`` anchors by their best class score are decoded, rotated-BEV
NMS runs per class at ``nms_thr`` over the scores above ``score_thr``,
the best ``max_num`` survivors across classes are kept, and the yaw gets
the direction classifier's fix.  The head's maps are NCHW here; ``predict``
reads them in the JAX package's (y, x, anchor, class) order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn

from geomae_tpu.config import AnchorHeadConfig

from ..core import boxes as B
from ..ops.rotated_iou import boxes_iou_bev
from . import box_coder
from .second import Conv2d


class HeadOutputs(NamedTuple):
    cls: torch.Tensor   # [B, A * num_classes, H, W]
    reg: torch.Tensor   # [B, A * code_size, H, W]
    dir: torch.Tensor   # [B, A * 2, H, W]


class Detections(NamedTuple):
    boxes: torch.Tensor    # [B, max_num, 9]
    scores: torch.Tensor   # [B, max_num]
    labels: torch.Tensor   # [B, max_num]
    valid: torch.Tensor    # [B, max_num] bool


class Anchor3DHead(nn.Module):
    """Three 1x1 convolutions over the FPN map."""

    def __init__(self, cfg: AnchorHeadConfig, device=None):
        super().__init__()
        A = len(cfg.anchor_sizes) * len(cfg.rotations)
        cin = cfg.feat_channels
        self.conv_cls = Conv2d(cin, A * cfg.num_classes, 1, device=device)
        self.conv_reg = Conv2d(cin, A * cfg.code_size, 1, device=device)
        self.conv_dir_cls = Conv2d(cin, A * 2, 1, device=device)

    def forward(self, x: torch.Tensor) -> HeadOutputs:
        return HeadOutputs(cls=self.conv_cls(x), reg=self.conv_reg(x),
                           dir=self.conv_dir_cls(x))


def _nms_from_iou(iou: torch.Tensor, order: torch.Tensor,
                  valid_sorted: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy NMS for a batch of rankings at once.

    iou [K, K] over the candidates; order [N, K] one ranking per row (here
    one per class); valid_sorted [N, K].  Returns the keep mask [N, K] in
    ranked order.  Step i lets the i-th ranked box of every row, if still
    alive and valid, remove every other box it overlaps above ``thr``:
    the JAX loop per class, run for all classes together.
    """
    N, K = order.shape
    sup = iou[order[:, :, None], order[:, None, :]] > thr      # [N, K, K]
    sup.diagonal(dim1=1, dim2=2).fill_(False)
    alive = torch.ones_like(valid_sorted)
    for i in range(K):
        keep_i = alive[:, i] & valid_sorted[:, i]
        alive &= ~(sup[:, i] & keep_i[:, None])
    return alive & valid_sorted


class Candidates(NamedTuple):
    """One sample's top ``nms_pre`` anchors, decoded."""
    boxes: torch.Tensor       # [k, 9]
    scores: torch.Tensor      # [C, k] sigmoid scores per class
    dir_score: torch.Tensor   # [k] direction bin
    iou: torch.Tensor         # [k, k] rotated BEV IoU
    order: torch.Tensor       # [C, k] candidates by descending class score


def candidates(cls: torch.Tensor, reg: torch.Tensor, dirp: torch.Tensor,
               anchors: torch.Tensor, cfg: AnchorHeadConfig) -> Candidates:
    """One sample's head maps [A*X, H, W] -> its decoded candidates."""
    C = cfg.num_classes
    scores = torch.sigmoid(cls.permute(1, 2, 0).reshape(-1, C).float())
    reg = reg.permute(1, 2, 0).reshape(-1, cfg.code_size).float()
    dir_score = dirp.permute(1, 2, 0).reshape(-1, 2).argmax(-1)
    k = min(cfg.nms_pre, scores.shape[0])
    top = torch.topk(scores.amax(-1), k).indices
    boxes = box_coder.decode(reg[top], anchors[top])
    scores = scores[top].t()
    bev = B.bev(boxes)
    return Candidates(boxes=boxes, scores=scores, dir_score=dir_score[top],
                      iou=boxes_iou_bev(bev, bev),
                      order=torch.argsort(-scores, dim=1, stable=True))


def select(c: Candidates, keep_sorted: torch.Tensor, cfg: AnchorHeadConfig):
    """The best ``max_num`` NMS survivors across classes, with the
    direction-aware yaw: (boxes, scores, labels, valid)."""
    k = c.boxes.shape[0]
    keep = torch.zeros_like(keep_sorted).scatter_(1, c.order, keep_sorted)
    scores_c = torch.where(keep, c.scores, -1.0).reshape(-1)  # class-major
    sc_top, idx = torch.topk(scores_c, cfg.max_num)
    cand = idx % k
    labels = torch.div(idx, k, rounding_mode="floor").to(torch.int32)
    boxes = c.boxes[cand]
    valid = keep.reshape(-1)[idx] & (sc_top > 0)
    # dir_limit_offset 1 (anchor3d_head.py:545-548 of the reference)
    dir_rot = B.limit_period(boxes[:, 6] - cfg.dir_offset, 1, math.pi)
    boxes[:, 6] = (dir_rot + cfg.dir_offset
                   + math.pi * c.dir_score[cand].float())
    return boxes, sc_top, labels, valid


def predict(out: HeadOutputs, anchors: torch.Tensor,
            cfg: AnchorHeadConfig) -> Detections:
    """Batched decode and NMS; fixed-size detections per sample."""
    results = []
    for cls, reg, dirp in zip(out.cls, out.reg, out.dir):
        c = candidates(cls, reg, dirp, anchors, cfg)
        ok_sorted = torch.gather(c.scores > cfg.score_thr, 1, c.order)
        keep_sorted = _nms_from_iou(c.iou, c.order, ok_sorted, cfg.nms_thr)
        results.append(select(c, keep_sorted, cfg))
    return Detections(*[torch.stack(t) for t in zip(*results)])
