"""DynamicVoxelNet, the SST detection model, and VoxelNet.

Port of ``geomae_tpu/models/detector.py`` (``DynamicVoxelNet``,
``VoxelNet``, ``extract_scene``): voxelize -> DynamicScatterVFE -> window
layouts -> SST blocks -> recover_bev -> SECOND stages -> SECONDFPN ->
Anchor3DHead, or the CenterHead with ``cfg.head_type == "center"``.
``VoxelNet``, the PointPillars detector, takes the pillar encoder or the
hard-voxelized mean in place of the VFE and the SST.

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

from ..config import FinetuneConfig, replace

from ..ops.voxelize import Scene, build_scene_batch, hard_voxelize
from ..ops.windows import make_layouts
from .anchor_head import Anchor3DHead, HeadOutputs
from .center_head import CenterHead
from .pillar_encoders import PillarFeatureNet, hard_simple_vfe
from .second import SECONDFPN, SECONDStages, recover_bev
from .sst import SSTStack, prepare_shift_data
from .vfe import DynamicScatterVFE


class _Backbone(nn.Module):
    """The reference backbone's two halves under their checkpoint names.
    SECOND takes the width the SST hands it (the VFE's where there is no
    SST block), as flax's ``nn.Conv`` infers it in the JAX package, not
    ``cfg.second.in_channels``."""

    def __init__(self, cfg: FinetuneConfig, device=None):
        super().__init__()
        self.encoder_blocks = SSTStack(cfg.sst, cfg.num_blocks, device)
        width = (cfg.sst.d_model if cfg.num_blocks
                 else cfg.vfe.feat_channels[-1])
        self.conv_blocks = SECONDStages(
            replace(cfg.second, in_channels=width), device)


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


class _SECONDBackbone(nn.Module):
    """The SECOND stages under the name the SST detectors give them."""

    def __init__(self, cfg: FinetuneConfig, in_channels: int, device=None):
        super().__init__()
        self.conv_blocks = SECONDStages(
            replace(cfg.second, in_channels=in_channels), device)


class VoxelNet(nn.Module):
    """The hard-voxelization single-stage detector (mmdet3d's
    ``detectors/voxelnet.py:13-48``): voxel encoder -> PointPillarsScatter
    BEV -> SECOND -> FPN -> head.

    ``encoder="pillar"`` runs ``PillarFeatureNet`` on the sorted scene
    (``cfg.vfe``, ``voxel_encoder.pfn_layers``); ``encoder="simple"`` the
    ``HardSimpleVFE`` mean of the first 4 features over ``hard_voxelize``
    buffers of ``max_points_per_voxel`` slots (no parameters).  SECOND
    takes the encoder's width, 4 channels for ``simple``, where the JAX
    module infers it.  The SECOND stages are ``backbone.conv_blocks``, as
    in ``DynamicVoxelNet``, so ``weights.from_flax`` maps a JAX
    ``VoxelNet``'s ``second`` tree alike."""

    def __init__(self, cfg: FinetuneConfig, encoder: str = "pillar",
                 max_points_per_voxel: int = 32, device=None):
        super().__init__()
        if cfg.head_type not in ("anchor", "center"):
            raise ValueError(f"head_type {cfg.head_type!r}: anchor or center")
        if encoder not in ("pillar", "simple"):
            raise ValueError(f"encoder {encoder!r}: pillar or simple")
        self.cfg, self.encoder = cfg, encoder
        self.max_points_per_voxel = max_points_per_voxel
        if encoder == "pillar":
            self.voxel_encoder = PillarFeatureNet(cfg.vfe, cfg.voxel, device)
            width = cfg.vfe.feat_channels[-1]
        else:
            width = 4
        self.backbone = _SECONDBackbone(cfg, width, device)
        self.neck = SECONDFPN(cfg.fpn, device)
        self.bbox_head = CenterHead(cfg.center_head, device) \
            if cfg.head_type == "center" else Anchor3DHead(cfg.head, device)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def forward(self, scene: Scene) -> HeadOutputs | List[Dict]:
        cfg = self.cfg
        table = scene.table
        ny, nx = cfg.voxel.grid_size
        if self.encoder == "simple":
            voxels, npts = hard_voxelize(scene, self.max_points_per_voxel)
            feats = hard_simple_vfe(voxels, npts)
        else:
            feats = self.voxel_encoder(scene, self.dtype)
        bev = recover_bev(feats.to(self.dtype), table.coords, table.valid,
                          ny, nx)
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
