"""DynamicVoxelNet, the SST detection model.

Port of ``geomae_tpu/models/detector.py`` (``DynamicVoxelNet``,
``extract_scene``): voxelize -> DynamicScatterVFE -> window layouts ->
SST blocks -> recover_bev -> SECOND stages -> SECONDFPN -> Anchor3DHead,
or the CenterHead with ``cfg.head_type == "center"``.

The module tree carries the reference checkpoint's names
(``voxel_encoder``, ``backbone.encoder_blocks``, ``backbone.conv_blocks``,
``neck``, ``bbox_head``), so a reference ``state_dict`` loads with
``load_state_dict(strict=True)``.  Parameters stay float32; the model
computes in ``cfg.compute_dtype``.  ``model.train()`` gives the JAX
model's ``train=True`` forward (batch statistics in every BatchNorm);
gradients reach the parameters through the kernels' backward.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn

from ..config import FinetuneConfig

from ..ops.voxelize import Scene, build_scene_batch
from ..ops.windows import make_layouts
from .anchor_head import Anchor3DHead, HeadOutputs
from .center_head import CenterHead
from .second import SECONDFPN, SECONDStages, recover_bev
from .sst import SSTStack, prepare_shift_data
from .vfe import DynamicScatterVFE


class _Backbone(nn.Module):
    """The reference backbone's two halves under their checkpoint names."""

    def __init__(self, cfg: FinetuneConfig, device=None):
        super().__init__()
        self.encoder_blocks = SSTStack(cfg.sst, cfg.num_blocks, device)
        self.conv_blocks = SECONDStages(cfg.second, device)


class DynamicVoxelNet(nn.Module):
    def __init__(self, cfg: FinetuneConfig, device=None):
        super().__init__()
        if cfg.head_type not in ("anchor", "center"):
            raise ValueError(f"head_type {cfg.head_type!r}: anchor or center")
        self.cfg = cfg
        self.voxel_encoder = DynamicScatterVFE(cfg.vfe, cfg.voxel, device)
        self.backbone = _Backbone(cfg, device)
        self.neck = SECONDFPN(cfg.fpn, device)
        self.bbox_head = CenterHead(cfg.center_head, device) \
            if cfg.head_type == "center" else Anchor3DHead(cfg.head, device)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def forward(self, scene: Scene) -> HeadOutputs | List[Dict]:
        """The anchor head's ``HeadOutputs``, or the CenterHead's list of
        per-task dicts of maps."""
        cfg = self.cfg
        table = scene.table
        ny, nx = cfg.voxel.grid_size
        feats = self.voxel_encoder(scene, self.dtype)
        layouts = make_layouts(table.coords, table.valid, cfg.sst, cfg.voxel)
        shift_data = prepare_shift_data(layouts, table.valid, cfg.sst)
        x = self.backbone.encoder_blocks(feats, shift_data)
        bev = recover_bev(x, table.coords, table.valid, ny, nx)
        fpn = self.neck(self.backbone.conv_blocks(bev))
        return self.bbox_head(fpn)


def extract_scene(cfg: FinetuneConfig, points: torch.Tensor,
                  point_valid: torch.Tensor) -> Scene:
    return build_scene_batch(points, point_valid, cfg.voxel,
                             cfg.caps.max_voxels)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer from ``generator``: He-uniform
    weights (+-sqrt(6/fan_in), the ReLU gain) for the Linears and
    convolutions, so that random weights keep activations of order one
    through the 16 conv layers and the head's outputs depend on the input;
    biases +-1/sqrt(fan_in); Xavier for the fused q/k/v projection; ones
    and zeros for the norms.  Values are drawn on the CPU in a fixed module
    order, so one seed gives the same weights on every device.  Random
    weights that are served (``apis.Detector3D`` without a checkpoint)
    start here; the training entry points start from
    ``init_weights_reference``."""
    def uniform(t: torch.Tensor, bound: float) -> None:
        _uniform(t, bound, generator)

    for m in model.modules():
        if isinstance(m, nn.MultiheadAttention):
            fan_out, fan_in = m.in_proj_weight.shape
            uniform(m.in_proj_weight, math.sqrt(6.0 / (fan_in + fan_out)))
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(m, nn.ConvTranspose2d):
                # each output pixel sees in_channels x (kernel / stride) taps
                fan_in = (m.in_channels * math.prod(m.kernel_size)
                          // math.prod(m.stride))
            else:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            uniform(m.weight, math.sqrt(6.0 / fan_in))
            if m.bias is not None:
                uniform(m.bias, 1.0 / math.sqrt(fan_in))
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            _unit_norm(m)
    _center_prior(model)


# lecun_normal's truncated normal has the standard deviation of a unit
# normal cut at +-2; flax divides by it so the draw's std is sqrt(1/fan_in)
_TRUNC_STD = .87962566103423978


@torch.no_grad()
def init_weights_reference(model: nn.Module,
                           generator: torch.Generator) -> None:
    """Fill every parameter and buffer from ``generator`` with the
    distribution the JAX package's initializer draws its counterpart from,
    the init of the training entry points (``train/finetune.py``,
    ``train/pretrain.py``).  Values are drawn on the CPU in module order,
    as ``init_weights`` draws them.  Biases are zero (flax's default),
    norms ones and zeros, BN running statistics 0 and 1.  Families:

    * VFE Linears: ``variance_scaling(1/3, fan_in, uniform)``, bound
      sqrt(1/fan_in) (``geomae_tpu/models/vfe.py:32``);
    * anchor-head convs: the same (``anchor_head.py:50``);
    * CenterHead convs: flax's default ``lecun_normal`` (below), the
      heatmap's final bias the constant ``init_bias`` (-2.19) and the
      other biases zero (``center_head.py:40-84``);
    * SECOND and FPN convs, transposed ones included: flax's default
      ``lecun_normal``, a unit normal cut at +-2 and scaled to the std
      sqrt(1/fan_in), fan_in = in x kh x kw of the flax kernel (kh, kw,
      in, out) (``second.py:61-112``);
    * SST q/k/v, out-projection and FFN Linears, and every other Linear
      (GeoMAE's six heads): ``xavier_uniform``, bound
      sqrt(6 / (fan_in + fan_out)) (``sst.py:199-291``,
      ``mae.py:559-588``).  The GeoMAE decoder pair's kernels are [G = 2,
      in, out] in JAX, and flax counts the group axis into both fans
      (``sst.py:205-215, 393-406``), which halves their variance.

    The mask token is GeoMAE's own (``train/pretrain.py``)."""
    def uniform(t: torch.Tensor, bound: float) -> None:
        _uniform(t, bound, generator)

    def lecun_normal(t: torch.Tensor, fan_in: int) -> None:
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        t.copy_(nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std,
                                      -2 * std, 2 * std,
                                      generator=generator))

    def xavier(t: torch.Tensor, fan_in: int, fan_out: int,
               groups: int) -> None:
        uniform(t, math.sqrt(6.0 / (groups * (fan_in + fan_out))))

    anchor_head = isinstance(getattr(model, "bbox_head", None), Anchor3DHead)
    for name, m in model.named_modules():
        groups = 2 if name.startswith(("backbone.decoder_centroid_blocks",
                                       "backbone.decoder_density_blocks")) \
            else 1
        if isinstance(m, nn.MultiheadAttention):
            C = m.embed_dim
            for rows in m.in_proj_weight.split(C):     # q, k, v: [C, C]
                xavier(rows, C, C, groups)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            if name.startswith("voxel_encoder."):
                uniform(m.weight, math.sqrt(1.0 / fan_in))
            else:
                xavier(m.weight, fan_in, fan_out, groups)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.in_channels * math.prod(m.kernel_size)
            else:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            if name.startswith("bbox_head.") and anchor_head:
                uniform(m.weight, math.sqrt(1.0 / fan_in))
            else:
                lecun_normal(m.weight, fan_in)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            _unit_norm(m)
    _center_prior(model)


def _center_prior(model: nn.Module) -> None:
    """The CenterHead's heatmap bias at its prior, where there is one."""
    if isinstance(getattr(model, "bbox_head", None), CenterHead):
        model.bbox_head.fill_heatmap_bias()


def _uniform(t: torch.Tensor, bound: float,
             generator: torch.Generator) -> None:
    """``t`` from U(-bound, bound), drawn on the CPU."""
    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))


def _unit_norm(m: nn.Module) -> None:
    """Ones and zeros for a norm's affine and running statistics."""
    m.weight.fill_(1.0)
    m.bias.zero_()
    if isinstance(m, nn.modules.batchnorm._BatchNorm):
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
        m.num_batches_tracked.zero_()
