"""Detection fine-tune: init (with the pretrain weight import), train
step, predict function, synthetic batches.

Port of ``geomae_tpu/train/finetune.py`` (``init_state``,
``load_pretrained``, ``make_train_step``, ``make_predict_fn``,
``dummy_batch``) for the anchor head and the CenterHead.  One step is
``loss_fn`` (voxelize, ``DynamicVoxelNet`` in training mode,
``head_loss`` or ``center_head_loss``) -> backward -> clip + AdamW, the
counterpart of ``value_and_grad`` ->
``apply_gradients``.  On a CUDA device the SST layers run K6/K7 and
K5 with its backward, and the VFE the segment kernels with their
gradients; the BN running statistics update in the forward, as the
JAX step's ``mutable=["batch_stats"]`` does.  A step made with a
``group`` (``parallel/mesh.py``) computes on the rank's rows what one
process computes on the whole batch, as the pretrain step does
(``train/pretrain.py``): global BN moments and positive count, the
gradients summed over the ranks, the whole batch's losses.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import FinetuneConfig
from ..data.transforms import pad_boxes, pad_points

from ..models.anchor_head import (Detections, decode_pre_nms, head_loss,
                                  predict, predict_wnms)
from ..models.anchors import grid_anchors, head_featmap_size
from ..models.center_head import center_head_decode, center_head_loss
from ..models.detector import (DynamicVoxelNet, extract_scene,
                               init_weights_reference)
from ..parallel.distributed import (all_reduce_grads, data_parallel,
                                    sum_losses)
from ..parallel.mesh import Group
from ..synthetic import clustered_scene
from ..utils.logging import get_root_logger
from .optim import AdamW
from .state import TrainState


def init_state(cfg: FinetuneConfig, device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None,
               pretrain: Optional[Mapping[str, torch.Tensor]] = None
               ) -> TrainState:
    """A fresh model on ``device`` with weights from ``generator``
    (default: seeded with ``cfg.seed``) drawn as the JAX initializer draws
    them (``init_weights_reference``), then from the GeoMAE
    ``state_dict`` ``pretrain`` where given (``load_pretrained``), in
    training mode, and its optimizer."""
    model = DynamicVoxelNet(cfg, device="meta").to_empty(device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights_reference(model, generator)
    if pretrain is not None:
        load_pretrained(model, pretrain)
    model.train()
    return TrainState(step=0, model=model, tx=AdamW(model, cfg.optim))


@torch.no_grad()
def load_pretrained(model: torch.nn.Module,
                    pretrain: Mapping[str, torch.Tensor]) -> List[str]:
    """Weights-only import of a pretrain checkpoint (``load_from``
    semantics): the GeoMAE ``voxel_encoder`` and ``backbone.
    encoder_blocks`` share their names with the detector, so every
    parameter of ``model`` with a tensor of the same name and shape in
    ``pretrain`` takes its values, in place; a tensor whose shape differs
    is skipped.  Parameters only: the BN running statistics stay the
    detector's own, as the JAX package imports its ``params`` tree alone.
    At least one tensor must match.  Returns the imported names."""
    params = dict(model.named_parameters())
    names = [k for k, p in params.items()
             if k in pretrain and pretrain[k].shape == p.shape]
    if not names:
        raise ValueError("no pretrained weights matched the detector")
    for k in names:
        params[k].copy_(pretrain[k])
    get_root_logger().info(
        "imported %d/%d pretrained tensors into the detector", len(names),
        len(params))
    return names


def _anchors(cfg: FinetuneConfig) -> Optional[np.ndarray]:
    """The anchor head's anchors; None for the CenterHead."""
    if cfg.head_type == "center":
        return None
    return grid_anchors(cfg.head, head_featmap_size(cfg))


def make_train_step(cfg: FinetuneConfig, group: Optional[Group] = None):
    """``train_step(state, batch) -> (state, losses)``: one update in
    place; ``losses`` holds loss_cls, loss_bbox, loss_dir (the CenterHead:
    ``task{i}.loss_heatmap`` and ``task{i}.loss_bbox`` per task) and their
    sum ``loss``, detached f32 scalars on the batch's device.  ``batch``:
    points [B, P, 5], point_valid [B, P], gt_boxes [B, G, 9], gt_labels
    [B, G], gt_mask [B, G] tensors on one device; with ``group``, the
    rank's rows of the global batch."""
    anchors_np = _anchors(cfg)
    anchors: Dict[torch.device, torch.Tensor] = {}

    def loss_fn(model: DynamicVoxelNet, batch) -> Dict[str, torch.Tensor]:
        dev = batch["points"].device
        gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
        scene = extract_scene(cfg, batch["points"], batch["point_valid"])
        with data_parallel(group):
            out = model(scene)
            if cfg.head_type == "center":
                losses = center_head_loss(out, *gt, cfg.center_head,
                                          cfg.voxel)
            else:
                if dev not in anchors:
                    anchors[dev] = torch.from_numpy(anchors_np).to(dev)
                losses = head_loss(out, anchors[dev], *gt, cfg.head)
        losses["loss"] = sum(losses.values())
        return losses

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        state.model.train()
        for p in state.model.parameters():
            p.grad = None
        losses = loss_fn(state.model, batch)
        losses["loss"].backward()
        all_reduce_grads(state.model, group)
        state.tx.step()
        state.step += 1
        return state, sum_losses(losses, group)

    train_step.loss_fn = loss_fn
    return train_step


def make_predict_fn(cfg: FinetuneConfig, wnms: bool = False):
    """``predict_fn(state, batch) -> Detections``: the model in eval mode
    (left in training mode afterwards), then the anchor head's decode and
    greedy NMS per class, or the CenterHead's decode and NMS per task.
    With ``wnms`` (anchor head only) the top anchors are decoded on the
    device (``decode_pre_nms``) and merged by weighted NMS on the host
    (``predict_wnms``), whose ``Detections`` lie on the CPU."""
    if wnms and cfg.head_type == "center":
        raise ValueError("wnms applies to the anchor head only")
    anchors_np = _anchors(cfg)

    @torch.no_grad()
    def predict_fn(state: TrainState, batch) -> Detections:
        scene = extract_scene(cfg, batch["points"], batch["point_valid"])
        state.model.eval()
        try:
            out = state.model(scene)
        finally:
            state.model.train()
        if cfg.head_type == "center":
            return center_head_decode(out, cfg.center_head, cfg.voxel)
        anchors = torch.from_numpy(anchors_np).to(batch["points"].device)
        if wnms:
            return predict_wnms(*decode_pre_nms(out, anchors, cfg.head),
                                cfg.head)
        return predict(out, anchors, cfg.head)

    return predict_fn


def synthetic_batch(cfg: FinetuneConfig, batch_size: int, seed: int = 0,
                    device: torch.device | str = "cuda") -> Dict:
    """A batch of ``clustered_scene`` frames from ``seed``, padded to the
    point cap and ``cfg.max_gt_boxes``, on ``device``."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("points", "point_valid", "gt_boxes",
                            "gt_labels", "gt_mask")}
    for _ in range(batch_size):
        pts, boxes, labels = clustered_scene(rng, cfg)
        p, v = pad_points(pts, cfg.caps.max_points)
        b, lab, m = pad_boxes(boxes, labels, cfg.max_gt_boxes)
        for k, a in zip(cols, (p, v, b, lab, m)):
            cols[k].append(a)
    return {k: torch.from_numpy(np.stack(a)).to(device)
            for k, a in cols.items()}
