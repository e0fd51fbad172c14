"""Anchor3DHead: target assignment, losses and detection decoding.

Port of ``geomae_tpu/models/anchor_head.py`` (``Anchor3DHead``,
``assign_targets``, ``head_loss``, ``Detections``, ``_nms_from_iou``,
``predict``, ``decode_pre_nms``, ``predict_wnms``).  Training assigns
each anchor by MaxIoU over nearest-BEV (axis-aligned) IoU (positive at
0.6, negative below 0.3, each GT's best anchors positive from 0.3, the
later GT winning), computed in chunks of 16,384 anchors so the [anchors
x GT] IoU matrix never materializes, and takes the focal, smooth-L1
(sin-difference rotation) and direction losses over the number of
positives.  In prediction, per sample, the top ``nms_pre`` anchors by
their best class score are decoded, rotated-BEV NMS runs per class at
``nms_thr`` over the scores above ``score_thr``, the best ``max_num``
survivors across classes are kept, and the yaw gets the direction
classifier's fix; with weighted NMS the top anchors are decoded on the
device and merged per class on the host (``predict_wnms``,
``core/wnms.py``).  Top-k selections take the lower index first among
ties, as ``jax.lax.top_k``.  The head's maps are NCHW here; ``predict``
reads them in the JAX package's (y, x, anchor, class) order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..config import AnchorHeadConfig

from ..core import boxes as B
from ..ops.rotated_iou import boxes_iou_bev, greedy_keep
from ..parallel.distributed import all_reduce_sum
from . import box_coder, losses
from .second import Conv2d

_CHUNK = 16384


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


class AnchorTargets(NamedTuple):
    labels: torch.Tensor         # [N] in [0, num_classes]; num_classes = bg
    label_weights: torch.Tensor  # [N]
    bbox_targets: torch.Tensor   # [N, 9]
    bbox_weights: torch.Tensor   # [N]
    dir_targets: torch.Tensor    # [N]
    num_pos: torch.Tensor        # []


def _iou_chunks(a4: torch.Tensor, g4: torch.Tensor, gt_valid: torch.Tensor):
    """Nearest-BEV IoU of anchor chunks against every GT, -1 for invalid
    GT: yields (chunk start, [chunk, G] IoU)."""
    for c0 in range(0, a4.shape[0], _CHUNK):
        iou = B.aligned_iou_2d(a4[c0:c0 + _CHUNK], g4)
        yield c0, torch.where(gt_valid[None, :], iou, -1.0)


@torch.no_grad()
def assign_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   cfg: AnchorHeadConfig) -> AnchorTargets:
    """One sample: anchors [N, 9], gt_boxes [G, 9], gt_labels [G],
    gt_valid [G] bool."""
    N, G = anchors.shape[0], gt_boxes.shape[0]
    a4, g4 = B.nearest_bev(anchors), B.nearest_bev(gt_boxes)
    amax = anchors.new_empty(N)
    aarg = torch.empty(N, dtype=torch.long, device=anchors.device)
    gmax = anchors.new_full((G,), -1.0)
    for c0, iou in _iou_chunks(a4, g4, gt_valid):
        amax[c0:c0 + _CHUNK] = iou.amax(-1)
        aarg[c0:c0 + _CHUNK] = iou.argmax(-1)    # the first maximal GT
        gmax = torch.maximum(gmax, iou.amax(0))
    # second pass: each GT's best anchors (every tie; the later GT wins)
    best_gt = torch.empty(N, dtype=torch.long, device=anchors.device)
    gi = torch.arange(G, device=anchors.device)
    for c0, iou in _iou_chunks(a4, g4, gt_valid):
        hit = ((iou == gmax[None, :]) & (gmax >= cfg.min_pos_iou)[None, :]
               & gt_valid[None, :])
        best_gt[c0:c0 + _CHUNK] = torch.where(hit, gi, -1).amax(-1)

    assigned = torch.full((N,), -1, dtype=torch.long, device=anchors.device)
    assigned = torch.where(amax < cfg.neg_iou_thr, -2, assigned)
    assigned = torch.where(amax >= cfg.pos_iou_thr, aarg, assigned)
    assigned = torch.where(best_gt >= 0, best_gt, assigned)
    pos, neg = assigned >= 0, assigned == -2
    safe_gt = assigned.clamp(0, G - 1)
    gt_for = gt_boxes[safe_gt]
    labels = torch.where(pos, gt_labels[safe_gt].long(), cfg.num_classes)
    bt = torch.where(pos[:, None], box_coder.encode(gt_for, anchors), 0.0)
    # direction bin of the GT yaw - dir_offset
    offset_rot = B.limit_period(gt_for[:, 6] - cfg.dir_offset, 0,
                                2 * math.pi)
    dir_t = torch.clamp(torch.floor(offset_rot / math.pi).long(), 0, 1)
    return AnchorTargets(labels=labels,
                         label_weights=(pos | neg).float(),
                         bbox_targets=bt, bbox_weights=pos.float(),
                         dir_targets=torch.where(pos, dir_t, 0),
                         num_pos=pos.sum())


def _sin_difference(pred: torch.Tensor, target: torch.Tensor):
    """sin(a - b) encoding of the rotation residual."""
    sin_p = torch.sin(pred[..., 6:7]) * torch.cos(target[..., 6:7])
    sin_t = torch.cos(pred[..., 6:7]) * torch.sin(target[..., 6:7])
    return (torch.cat([pred[..., :6], sin_p, pred[..., 7:]], -1),
            torch.cat([target[..., :6], sin_t, target[..., 7:]], -1))


def head_loss(out: HeadOutputs, anchors: torch.Tensor,
              gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              gt_mask: torch.Tensor, cfg: AnchorHeadConfig) -> dict:
    """Batched loss dict (loss_cls, loss_bbox, loss_dir), f32 scalars;
    gt_* [B, G, ...].  Inside ``data_parallel(group)`` the losses divide
    this rank's sums by the whole batch's positive count (one all-reduce,
    no gradient)."""
    Bz, C, code = out.cls.shape[0], cfg.num_classes, cfg.code_size
    flat = lambda t, n: t.permute(0, 2, 3, 1).reshape(Bz, -1, n).float()
    cls, reg, dirp = flat(out.cls, C), flat(out.reg, code), flat(out.dir, 2)
    tg = AnchorTargets(*map(torch.stack, zip(*[
        assign_targets(anchors, b, l, m, cfg)
        for b, l, m in zip(gt_boxes, gt_labels, gt_mask)])))
    # num_total_pos = sum(max(pos_i, 1))
    num_pos, = all_reduce_sum(torch.clamp(tg.num_pos, min=1).sum())
    num_pos = num_pos.float()
    loss_cls = losses.sigmoid_focal_loss(cls, tg.labels, C, cfg.focal_gamma,
                                         cfg.focal_alpha)
    loss_cls = (loss_cls * tg.label_weights).sum() / num_pos \
        * cfg.loss_cls_weight
    pos_w = tg.bbox_weights[..., None] * torch.tensor(
        cfg.code_weight, device=reg.device)
    pred_sin, tgt_sin = _sin_difference(reg, tg.bbox_targets)
    loss_bbox = losses.smooth_l1(pred_sin, tgt_sin, cfg.smooth_l1_beta)
    loss_bbox = (loss_bbox * pos_w).sum() / num_pos * cfg.loss_bbox_weight
    loss_dir = losses.softmax_ce(dirp, tg.dir_targets)
    loss_dir = (loss_dir * tg.bbox_weights).sum() / num_pos \
        * cfg.loss_dir_weight
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_dir=loss_dir)


def _nms_from_iou(iou: torch.Tensor, order: torch.Tensor,
                  valid_sorted: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy NMS for a batch of rankings at once: iou [K, K] over the
    candidates; order [N, K] one ranking per row (here one per class);
    valid_sorted [N, K].  Returns the keep mask [N, K] in ranked order:
    the JAX loop per class, run for all classes together
    (``greedy_keep``)."""
    sup = iou[order[:, :, None], order[:, None, :]] > thr      # [N, K, K]
    return greedy_keep(sup, valid_sorted)


class Candidates(NamedTuple):
    """One sample's top ``nms_pre`` anchors, decoded."""
    boxes: torch.Tensor       # [k, 9]
    scores: torch.Tensor      # [C, k] sigmoid scores per class
    dir_score: torch.Tensor   # [k] direction bin
    iou: torch.Tensor         # [k, k] rotated BEV IoU
    order: torch.Tensor       # [C, k] candidates by descending class score


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest of each row of ``x``, the lower index first among
    equal values (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none): (values, indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _decode_top(cls: torch.Tensor, reg: torch.Tensor, dirp: torch.Tensor,
                anchors: torch.Tensor, cfg: AnchorHeadConfig):
    """One sample's head maps [A*X, H, W] -> its top ``nms_pre`` anchors
    by best class score, decoded: (boxes [k, 9], sigmoid scores [k, C],
    direction bins [k])."""
    C = cfg.num_classes
    scores = torch.sigmoid(cls.permute(1, 2, 0).reshape(-1, C).float())
    reg = reg.permute(1, 2, 0).reshape(-1, cfg.code_size).float()
    dir_score = dirp.permute(1, 2, 0).reshape(-1, 2).argmax(-1)
    top = top_k(scores.amax(-1), min(cfg.nms_pre, scores.shape[0]))[1]
    return box_coder.decode(reg[top], anchors[top]), scores[top], \
        dir_score[top]


def candidates(cls: torch.Tensor, reg: torch.Tensor, dirp: torch.Tensor,
               anchors: torch.Tensor, cfg: AnchorHeadConfig) -> Candidates:
    """One sample's head maps [A*X, H, W] -> its decoded candidates."""
    boxes, scores, dir_score = _decode_top(cls, reg, dirp, anchors, cfg)
    scores = scores.t()
    bev = B.bev(boxes)
    return Candidates(boxes=boxes, scores=scores, dir_score=dir_score,
                      iou=boxes_iou_bev(bev, bev),
                      order=torch.argsort(-scores, dim=1, stable=True))


def select(c: Candidates, keep_sorted: torch.Tensor, cfg: AnchorHeadConfig):
    """The best ``max_num`` NMS survivors across classes, with the
    direction-aware yaw: (boxes, scores, labels, valid)."""
    k = c.boxes.shape[0]
    keep = torch.zeros_like(keep_sorted).scatter_(1, c.order, keep_sorted)
    scores_c = torch.where(keep, c.scores, -1.0).reshape(-1)  # class-major
    sc_top, idx = top_k(scores_c, cfg.max_num)
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


def decode_pre_nms(out: HeadOutputs, anchors: torch.Tensor,
                   cfg: AnchorHeadConfig):
    """Batched top-``nms_pre`` decode without NMS, the device half of the
    weighted-NMS prediction: (boxes [B, k, code_size], scores [B, k, C],
    direction bins [B, k])."""
    return tuple(torch.stack(t) for t in zip(*[
        _decode_top(c, r, d, anchors, cfg)
        for c, r, d in zip(out.cls, out.reg, out.dir)]))


def predict_wnms(boxes, scores, dir_scores, cfg: AnchorHeadConfig,
                 thr_suppress: float = 0.1, thr_vote: float = 0.7,
                 use_3d: bool = False) -> Detections:
    """The host half of the weighted-NMS prediction over
    ``decode_pre_nms``'s outputs (the reference's wnms_cpu branch): the
    per-class weighted merge (``core/wnms.py``) on the CPU, then the
    direction-aware yaw of the merged boxes; each class's IoU matrix is
    computed on the predictions' device.  Returns ``Detections`` padded
    to ``cfg.max_num`` rows (scores -1, invalid), on the CPU."""
    from ..core.wnms import box3d_multiclass_wnms

    device = boxes.device if isinstance(boxes, torch.Tensor) else "cpu"
    boxes = torch.as_tensor(boxes).float().cpu().numpy()
    scores = torch.as_tensor(scores).float().cpu().numpy()
    dir_scores = torch.as_tensor(dir_scores).cpu().numpy()
    Bn, _, code = boxes.shape
    m = cfg.max_num
    out_b = np.zeros((Bn, m, code), np.float32)
    out_s = np.full((Bn, m), -1.0, np.float32)
    out_l = np.zeros((Bn, m), np.int32)
    out_v = np.zeros((Bn, m), bool)
    for b in range(Bn):
        # sigmoid scores take a dummy background column
        sc = np.concatenate(
            [scores[b], np.zeros((scores.shape[1], 1), np.float32)], -1)
        bx, ss, ll, ds = box3d_multiclass_wnms(
            boxes[b, :, :7], sc, cfg.score_thr, m, thr_suppress, thr_vote,
            use_3d, dir_scores[b], device)
        n = len(ss)
        if n == 0:
            continue
        # dir_limit_offset 1 on the merged boxes
        dir_rot = B.limit_period(torch.from_numpy(bx[:, 6]) - cfg.dir_offset,
                                 1, math.pi).numpy()
        out_b[b, :n, :7] = bx
        out_b[b, :n, 6] = dir_rot + cfg.dir_offset \
            + np.pi * ds.astype(np.float32)
        out_s[b, :n] = ss
        out_l[b, :n] = ll
        out_v[b, :n] = True
    return Detections(boxes=torch.from_numpy(out_b),
                      scores=torch.from_numpy(out_s),
                      labels=torch.from_numpy(out_l),
                      valid=torch.from_numpy(out_v))
