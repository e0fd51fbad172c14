"""CenterHead (CenterPoint): per-task separate heads, gaussian heatmap
targets, L1 regression, top-k decode and per-task rotated NMS.

Port of ``geomae_tpu/models/center_head.py`` (``SeparateHead``,
``CenterHead``, ``gaussian_radius_feat``, ``compute_center_targets``,
``center_head_loss``, ``decode_task``, ``center_head_decode``).  The maps
are NCHW here, where the JAX package keeps NHWC; both flatten a heatmap
as ``c * H * W + y * W + x`` and a regression map as [H * W, channels].
The submodules carry the names of the reference's ``CenterHead`` /
``SeparateHead`` (mmdet3d v0.15 ``dense_heads/centerpoint_head.py``):
``shared_conv.{conv,bn}``, ``task_heads.{i}.{head}.0.{conv,bn}`` and
``task_heads.{i}.{head}.1.{weight,bias}``.

The targets are computed for the whole batch at once, without loops over
objects: the heatmap at a pixel is the largest gaussian of the objects
whose (2r + 1)^2 window holds it, a dense [B, H, W, G] broadcast.  Top-k
selections take the lower index first among equal values, as
``jax.lax.top_k`` does (``anchor_head.top_k``).  The decode runs the
rotated NMS of every task and sample in one greedy loop
(``ops.rotated_iou.nms_bev``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import CenterHeadConfig, VoxelConfig

from ..ops.rotated_iou import nms_bev
from ..parallel.distributed import all_reduce_sum
from .anchor_head import Detections, top_k
from .norm import MaskedBatchNorm2d
from .second import Conv2d

# the regression maps in the order of the target's 10 columns
_REG = ("reg", "height", "dim", "rot", "vel")


class ConvModule(nn.Sequential):
    """Conv3x3 (no bias) + BN + ReLU under mmcv's ``ConvModule`` names
    (``conv``, ``bn``)."""

    def __init__(self, cin: int, cout: int, eps: float, momentum: float,
                 device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1, bias=False,
                           device=device)
        self.bn = MaskedBatchNorm2d(cout, eps=eps, momentum=momentum,
                                    device=device)
        self.activate = nn.ReLU()


class SeparateHead(nn.Module):
    """One branch per output (``common_heads`` then ``heatmap``): a
    ConvModule, then a 3x3 conv with bias."""

    def __init__(self, cfg: CenterHeadConfig, num_cls: int, device=None):
        super().__init__()
        heads = dict(cfg.common_heads, heatmap=num_cls)
        self.heads = tuple(heads)
        c = cfg.share_conv_channel
        for name, cout in heads.items():
            self.add_module(name, nn.Sequential(
                ConvModule(c, c, cfg.bn_eps, cfg.bn_momentum, device),
                Conv2d(c, cout, 3, padding=1, bias=True, device=device)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)(x) for name in self.heads}


class CenterHead(nn.Module):
    """Shared ConvModule, then one ``SeparateHead`` per task; ``forward``
    returns one dict of NCHW maps per task."""

    def __init__(self, cfg: CenterHeadConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.shared_conv = ConvModule(cfg.in_channels, cfg.share_conv_channel,
                                      cfg.bn_eps, cfg.bn_momentum, device)
        self.task_heads = nn.ModuleList(
            SeparateHead(cfg, len(t), device) for t in cfg.tasks)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        h = self.shared_conv(x)
        return [head(h) for head in self.task_heads]

    @torch.no_grad()
    def fill_heatmap_bias(self) -> None:
        """The heatmap's final bias at ``init_bias`` (-2.19, a prior of
        0.1), as both packages initialize it."""
        for head in self.task_heads:
            head.heatmap[1].bias.fill_(self.cfg.init_bias)


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------


def _div(t: torch.Tensor, *divisors: float) -> torch.Tensor:
    """``t`` divided by each constant in turn, as XLA compiles the JAX
    package's ``t / c``: times the f32 reciprocal of ``c``.  A centre that
    true division puts on a pixel edge (y = 0.0 m is 50.0 pixels of the
    full preset's map) then lands on the same pixel in both packages
    (49.999996, pixel 49)."""
    for c in divisors:
        t = t * float(np.float32(1.0) / np.float32(c))
    return t


def gaussian_radius_feat(length_px: torch.Tensor, width_px: torch.Tensor,
                         min_overlap: float) -> torch.Tensor:
    """CenterPoint's radius formula.  As the reference does, all three
    quadratic roots are halved, also r2 (leading coefficient 4) and r3
    (negative b3): the CornerNet variant, kept exactly."""
    h, w = length_px, width_px
    b1 = h + w
    c1 = _div(w * h * (1 - min_overlap), 1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp_min(0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt((b2 ** 2 - 16 * c2).clamp_min(0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp_min(0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


class CenterTargets(NamedTuple):
    heatmap: torch.Tensor   # [B, num_classes, H, W]
    anno: torch.Tensor      # [B, max_objs, 10]
    inds: torch.Tensor      # [B, max_objs] flat pixel index y * W + x
    mask: torch.Tensor      # [B, max_objs] bool
    cls: torch.Tensor       # [B, max_objs] global class id


@torch.no_grad()
def compute_center_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                           gt_mask: torch.Tensor, cfg: CenterHeadConfig,
                           voxel: VoxelConfig,
                           featmap: Tuple[int, int]) -> CenterTargets:
    """The targets of a batch: gt_boxes [B, G, 9] (z at the bottom),
    gt_labels [B, G], gt_mask [B, G] bool."""
    H, W = featmap
    G = gt_boxes.shape[1]
    dev = gt_boxes.device
    r = voxel.point_cloud_range
    fac = cfg.out_size_factor
    vx, vy = voxel.voxel_size[0], voxel.voxel_size[1]
    gt_boxes = gt_boxes.float()

    wpx = _div(gt_boxes[..., 3], vx, fac)
    lpx = _div(gt_boxes[..., 4], vy, fac)
    radius = gaussian_radius_feat(lpx, wpx, cfg.gaussian_overlap)
    radius = torch.floor(radius).to(torch.int32).clamp_min(cfg.min_radius)

    cx = _div(gt_boxes[..., 0] - r[0], vx, fac)
    cy = _div(gt_boxes[..., 1] - r[1], vy, fac)
    # truncation toward zero (the reference's ``center.to(torch.int32)``):
    # cx in (-1, 0) lands on pixel 0
    ix = cx.to(torch.int32)
    iy = cy.to(torch.int32)
    ok = (gt_mask & (wpx > 0) & (lpx > 0)
          & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H))

    py = torch.arange(H, dtype=torch.int32, device=dev)
    px = torch.arange(W, dtype=torch.int32, device=dev)
    dx = px[None, None, :, None] - ix[:, None, None, :]        # [B, 1, W, G]
    dy = py[None, :, None, None] - iy[:, None, None, :]        # [B, H, 1, G]
    rad = radius[:, None, None, :]
    sigma = _div((2 * radius + 1).float(), 6.0)
    d2 = dx.float() ** 2 + dy.float() ** 2
    g = torch.exp(-d2 / (2 * sigma[:, None, None, :] ** 2))   # [B, H, W, G]
    win = (dx.abs() <= rad) & (dy.abs() <= rad)
    g = torch.where(win & ok[:, None, None, :], g, 0.0)
    heatmap = torch.stack([
        torch.where(((gt_labels == c) & ok)[:, None, None, :], g, 0.0)
        .amax(-1) for c in range(cfg.num_classes)], 1)

    zc = gt_boxes[..., 2] + gt_boxes[..., 5] / 2           # gravity centre
    dims = gt_boxes[..., 3:6]
    if cfg.norm_bbox:
        dims = torch.log(dims.clamp_min(1e-4))
    anno = torch.cat([
        (cx - ix)[..., None], (cy - iy)[..., None], zc[..., None], dims,
        torch.sin(gt_boxes[..., 6:7]), torch.cos(gt_boxes[..., 6:7]),
        gt_boxes[..., 7:9]], -1)
    anno = torch.where(ok[..., None], anno, 0.0)
    inds = torch.where(ok, iy * W + ix, 0)
    cap = min(G, cfg.max_objs)
    return CenterTargets(heatmap=heatmap, anno=anno[:, :cap],
                         inds=inds[:, :cap], mask=ok[:, :cap],
                         cls=gt_labels[:, :cap])


def _task_slices(cfg: CenterHeadConfig) -> List[Tuple[int, int]]:
    """Each task's range of global class ids."""
    out, start = [], 0
    for t in cfg.tasks:
        out.append((start, start + len(t)))
        start += len(t)
    return out


def _clip_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x).clamp(1e-4, 1 - 1e-4)


def _gaussian_focal(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mmdet's ``GaussianFocalLoss`` (alpha 2, gamma 4), elementwise."""
    eps = 1e-12
    pos_loss = -torch.log(pred + eps) * (1 - pred) ** 2
    neg_loss = -torch.log(1 - pred + eps) * pred ** 2 * (1 - target) ** 4
    return torch.where(target == 1.0, pos_loss, neg_loss)


def center_head_loss(task_preds: List[Dict[str, torch.Tensor]],
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_mask: torch.Tensor, cfg: CenterHeadConfig,
                     voxel: VoxelConfig) -> Dict[str, torch.Tensor]:
    """The batch's loss dict: ``task{i}.loss_heatmap`` (gaussian focal over
    the positive pixels' count) and ``task{i}.loss_bbox`` (L1 with the
    code weights over the task's objects' count, times
    ``loss_bbox_weight``).  Inside ``data_parallel(group)`` both counts
    are the whole batch's (one all-reduce each, no gradient), so the
    ranks' losses add up to one process's."""
    B, _, H, W = task_preds[0]["heatmap"].shape
    tg = compute_center_targets(gt_boxes, gt_labels, gt_mask, cfg, voxel,
                                (H, W))
    cw = torch.tensor(cfg.code_weights, device=gt_boxes.device)
    inds = tg.inds.long()[:, None, :].expand(B, 10, -1)
    losses = {}
    for ti, ((lo, hi), preds) in enumerate(zip(_task_slices(cfg),
                                               task_preds)):
        hm_pred = _clip_sigmoid(preds["heatmap"].float())
        hm_tgt = tg.heatmap[:, lo:hi]
        num_pos, = all_reduce_sum((hm_tgt == 1.0).sum().float())
        losses[f"task{ti}.loss_heatmap"] = (
            _gaussian_focal(hm_pred, hm_tgt).sum() / num_pos.clamp_min(1.0))

        anno_pred = torch.cat([preds[k].float() for k in _REG], 1)
        gathered = torch.gather(anno_pred.reshape(B, 10, H * W), 2,
                                inds).transpose(1, 2)       # [B, G, 10]
        in_task = (tg.cls >= lo) & (tg.cls < hi) & tg.mask
        num, = all_reduce_sum(in_task.float().sum())
        l1 = (gathered - tg.anno).abs() * (in_task[..., None].float() * cw)
        losses[f"task{ti}.loss_bbox"] = (l1.sum() / (num + 1e-4)
                                         * cfg.loss_bbox_weight)
    return losses


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_task(p: Dict[str, torch.Tensor], cfg: CenterHeadConfig,
                voxel: VoxelConfig):
    """One task, the whole batch: the top-k decode before NMS
    (``CenterPointBBoxCoder.decode``).  Returns boxes [B, K, 9] with the
    bottom z, scores [B, K], task-local classes [B, K] (int32) and the
    score and post-centre-range mask ok [B, K]."""
    B, _, H, W = p["heatmap"].shape
    r = voxel.point_cloud_range
    fac = cfg.out_size_factor
    vx, vy = voxel.voxel_size[0], voxel.voxel_size[1]
    pcr = torch.tensor(cfg.post_center_range, device=p["heatmap"].device)

    flat = torch.sigmoid(p["heatmap"].float()).reshape(B, -1)  # c*H*W+y*W+x
    scores, idx = top_k(flat, min(cfg.topk, flat.shape[1]))
    cls = torch.div(idx, H * W, rounding_mode="floor")
    pix = idx % (H * W)
    ys = torch.div(pix, W, rounding_mode="floor").float()
    xs = (pix % W).float()

    def gat(name):
        t = p[name].float().reshape(B, -1, H * W)
        return torch.gather(t, 2, pix[:, None, :].expand(-1, t.shape[1], -1)
                            ).transpose(1, 2)                 # [B, K, c]

    reg = gat("reg")
    x = (xs + reg[..., 0]) * fac * vx + r[0]
    y = (ys + reg[..., 1]) * fac * vy + r[1]
    zc = gat("height")[..., 0]
    dim = gat("dim")
    if cfg.norm_bbox:
        dim = torch.exp(dim)
    rot = gat("rot")
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    vel = gat("vel")
    z = zc - dim[..., 2] / 2
    boxes = torch.stack([x, y, z, dim[..., 0], dim[..., 1], dim[..., 2],
                         yaw, vel[..., 0], vel[..., 1]], -1)
    ctr = torch.stack([x, y, zc], -1)
    ok = (scores > cfg.score_threshold) \
        & ((ctr >= pcr[:3]) & (ctr <= pcr[3:])).all(-1)
    return boxes, scores, cls.to(torch.int32), ok


def center_head_decode(task_preds: List[Dict[str, torch.Tensor]],
                       cfg: CenterHeadConfig,
                       voxel: VoxelConfig) -> Detections:
    """Batched decode -> fixed-size ``Detections`` of ``topk`` rows: each
    task's top-k candidates, rotated NMS per task (``nms_thr``, one
    number or one per task, the Waymo variant's ``use_mul_nms``) keeping
    at most ``post_max_size``, then the best ``topk`` across tasks."""
    n_tasks = len(cfg.tasks)
    if isinstance(cfg.nms_thr, (tuple, list)) and \
            len(cfg.nms_thr) != n_tasks:
        raise ValueError(
            f"per-task nms_thr needs one threshold per task: got "
            f"{len(cfg.nms_thr)} thresholds for {n_tasks} tasks")
    dec = [decode_task(p, cfg, voxel) for p in task_preds]
    B = dec[0][0].shape[0]
    K = max(d[1].shape[1] for d in dec)
    # tasks with fewer than K candidates (a small map) get invalid rows
    pad = lambda t, v: t if t.shape[1] == K else torch.cat(
        [t, t.new_full((B, K - t.shape[1], *t.shape[2:]), v)], 1)
    boxes = torch.stack([pad(d[0], 0.0) for d in dec])        # [T, B, K, 9]
    scores = torch.stack([pad(d[1], 0.0) for d in dec])
    ok = torch.stack([pad(d[3], False) for d in dec])
    thr = cfg.nms_thr if isinstance(cfg.nms_thr, (tuple, list)) \
        else (cfg.nms_thr,) * n_tasks
    keep = nms_bev(boxes[..., [0, 1, 3, 4, 6]], scores, ok,
                   [t for t in thr for _ in range(B)], cfg.post_max_size)
    labels = torch.stack([pad(d[2] + lo, 0) for d, (lo, _) in
                          zip(dec, _task_slices(cfg))])
    cat = lambda t: torch.cat([t[i, :, :d[1].shape[1]]
                               for i, d in enumerate(dec)], 1)  # [B, T*K]
    scores_all = cat(torch.where(keep, scores, -1.0))
    sc, idx = top_k(scores_all, cfg.topk)
    boxes_all, labels_all, keep_all = cat(boxes), cat(labels), cat(keep)
    take = lambda t: torch.gather(t, 1, idx)
    return Detections(
        boxes=torch.gather(boxes_all, 1, idx[..., None].expand(-1, -1, 9)),
        scores=sc, labels=take(labels_all),
        valid=take(keep_all) & (sc > 0))
