"""GeoMAE pretrain step: init, train step, synthetic batches.

Port of ``geomae_tpu/train/pretrain.py`` (``build_model``, ``forward``,
``init_state``, ``make_train_step``, ``make_eval_step``,
``make_eval_hook``, ``dummy_batch``).  One step is
``forward`` (voxelize, geometric targets without gradient, the random
mask, ``GeoMAE`` in training mode, ``pretrain_loss``) -> backward -> clip
+ AdamW, the counterpart of ``value_and_grad`` -> ``apply_gradients``.
On a CUDA device the targets run K3 and K4, the VFE the segment kernels,
and the encoder's and both decoder branches' SST layers K6 / K5 with
their backward K7 / K5-backward.

Data parallelism: a step made with a ``group`` (``parallel/mesh.py``)
runs on the rank's rows of the global batch, draws the rank's rows of
the whole batch's mask, takes the batch norms' moments and the loss
denominators over the whole batch, sums the gradients over the ranks
before the clip and AdamW, and reports the whole batch's losses, so N
ranks compute the step one process computes on the whole batch.

The mask is drawn from a ``torch.Generator`` on the batch's device; a
caller that needs the same mask on two devices (a CUDA generator and a
CPU one draw different numbers) passes ``keep`` instead.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PretrainConfig
from ..data.transforms import pad_points
from ..models.detector import init_weights_reference
from ..models.mae import (GeoMAE, GeoMAETargets, compute_targets_batch,
                          pretrain_loss, sample_mask)
from ..ops.voxelize import Scene, build_scene_batch, scene_from_arrays
from ..parallel.distributed import (all_reduce_grads, data_parallel,
                                    sum_losses)
from ..parallel.mesh import Group
from ..synthetic import clustered_frame
from .optim import AdamW
from .state import TrainState


def build_model(cfg: PretrainConfig, device=None) -> GeoMAE:
    return GeoMAE(cfg, device=device)


@torch.no_grad()
def targets_and_mask(cfg: PretrainConfig, batch: Dict,
                     generator: Optional[torch.Generator] = None,
                     keep: Optional[torch.Tensor] = None
                     ) -> Tuple[Scene, GeoMAETargets, torch.Tensor]:
    """(scene, targets, keep) of ``batch`` (points [B, P, 5], point_valid
    [B, P]): the sorted scene, its geometric targets, and ``keep`` or a
    mask drawn from ``generator`` (inside ``data_parallel(group)``: the
    rank's rows of the whole batch's draw).  A batch that carries ``p2v``
    was sorted on the host (``NuScenesSSLDataset(precompute_scene=
    True)``) and skips the device sort."""
    if "p2v" in batch:
        scene = scene_from_arrays(batch)
    else:
        scene = build_scene_batch(batch["points"], batch["point_valid"],
                                  cfg.voxel, cfg.caps.max_voxels)
    targets = compute_targets_batch(scene, cfg)
    if keep is None:
        keep = sample_mask(generator, scene.table.valid,
                           cfg.mae.random_mask_ratio)
    return scene, targets, keep


def forward(cfg: PretrainConfig, model: GeoMAE, batch: Dict,
            generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None,
            group: Optional[Group] = None) -> Dict[str, torch.Tensor]:
    """Voxelize -> targets -> mask -> model -> loss, inside
    ``data_parallel(group)``; the loss dict (f32 scalars; with a group,
    the rank's terms of the whole batch's loss).  The BN statistics
    update in the model when it trains."""
    with data_parallel(group):
        scene, targets, keep = targets_and_mask(cfg, batch, generator, keep)
        return pretrain_loss(model(scene, keep), targets, scene, keep, cfg)


@torch.no_grad()
def init_weights_reference_geomae(model: GeoMAE,
                                  generator: torch.Generator) -> None:
    """GeoMAE's weights from the JAX initializer's distributions:
    ``detector.init_weights_reference`` (the VFE, the encoder, the
    decoder pair with its grouped fans, and the six heads, Xavier-uniform
    with zero biases, ``geomae_tpu/models/mae.py:559-588``), then the
    ``mask_token`` Xavier-uniform over its (1, C) shape (``mae.py:540``);
    values drawn on the CPU in module order, so one seed gives the same
    weights on every device."""
    init_weights_reference(model, generator)
    t = model.backbone.mask_token
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))


def init_state(cfg: PretrainConfig, device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None) -> TrainState:
    """A fresh GeoMAE on ``device`` with weights from ``generator``
    (default: seeded with ``cfg.seed``) drawn as the JAX initializer
    draws them (``init_weights_reference_geomae``), in training mode, and
    its optimizer (``cfg.optim``: AdamW, clip, the cyclic lr)."""
    model = build_model(cfg, device="meta").to_empty(device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights_reference_geomae(model, generator)
    model.train()
    return TrainState(step=0, model=model, tx=AdamW(model, cfg.optim))


def make_train_step(cfg: PretrainConfig, group: Optional[Group] = None):
    """``train_step(state, batch, generator, keep=None) -> (state,
    losses)``: one update in place.  ``losses`` holds the six terms and
    their sum ``loss``, detached f32 scalars on the batch's device;
    ``generator`` (on the batch's device) draws the mask unless ``keep``
    [B, V] is given.  With ``group``, ``batch`` and ``keep`` are the
    rank's rows and every rank passes a generator in the same state."""

    def loss_fn(model: GeoMAE, batch, generator=None, keep=None):
        return forward(cfg, model, batch, generator, keep, group)

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None,
                   keep: Optional[torch.Tensor] = None):
        state.model.train()
        for p in state.model.parameters():
            p.grad = None
        losses = loss_fn(state.model, batch, generator, keep)
        losses["loss"].backward()
        all_reduce_grads(state.model, group)
        state.tx.step()
        state.step += 1
        return state, sum_losses(losses, group)

    train_step.loss_fn = loss_fn
    return train_step


def make_eval_step(cfg: PretrainConfig, group: Optional[Group] = None):
    """``eval_step(state, batch, generator) -> losses``: the forward in
    eval mode (running BN statistics, no update, no gradient); the model
    is left in training mode.  With ``group``, ``batch`` is the rank's
    rows and the losses are the whole batch's, as the train step's."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch,
                  generator: Optional[torch.Generator] = None,
                  keep: Optional[torch.Tensor] = None):
        state.model.eval()
        try:
            return sum_losses(forward(cfg, state.model, batch, generator,
                                      keep, group), group)
        finally:
            state.model.train()

    return eval_step


def make_eval_hook(cfg: PretrainConfig, group: Optional[Group] = None):
    """``eval_fn(state, loader) -> mean loss dict`` for the trainer's
    periodic evaluation.  ``loader`` yields host batches (numpy arrays or
    tensors); the mask generator is seeded with 0 for every batch, so the
    metric is comparable across evaluations.  With ``group`` the loader
    yields the rank's rows and the means are the whole batches'."""
    estep = make_eval_step(cfg, group)

    def hook(state: TrainState, loader) -> Dict[str, float]:
        device = next(state.model.parameters()).device
        sums: Dict[str, float] = {}
        n = 0
        for batch in loader:
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batch.items()}
            gen = torch.Generator(device=device).manual_seed(0)
            for k, v in estep(state, batch, gen).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    return hook


def synthetic_batch(cfg: PretrainConfig, batch_size: int, seed: int = 0,
                    device: torch.device | str = "cuda") -> Dict:
    """A batch of ``clustered_frame`` clouds (``bench.py``'s distribution)
    from ``seed``, padded to the point cap, on ``device``."""
    rng = np.random.default_rng(seed)
    pts, valid = zip(*[pad_points(clustered_frame(rng, cfg.voxel,
                                                  cfg.caps.max_points),
                                  cfg.caps.max_points)
                       for _ in range(batch_size)])
    return dict(points=torch.from_numpy(np.stack(pts)).to(device),
                point_valid=torch.from_numpy(np.stack(valid)).to(device))
