"""DynamicScatterVFE, the pillar feature encoder (row-major).

Port of ``geomae_tpu/models/vfe.py`` (``DynamicVFELayer``,
``DynamicScatterVFE``):

  point features [x y z intensity dt]
    + offset from the pillar's point mean      (K2 segment_broadcast mean)
    + offset from the pillar centre                            -> 11 ch
    (+ the point's distance from the origin, ``with_distance``)
  -> Linear(11, 64, no bias) + BN + ReLU
  -> concat the pillar max back to each point  (K2 segment_broadcast max)
  -> Linear(128, 128, no bias) + BN + ReLU
  -> pillar max                                (K1 segment_reduce max)
  -> voxel features [B, V, 128], 0 on invalid rows

In training the BN statistics take every valid point (``scene.valid``),
the ones past the pillar cap included, as the JAX package passes
``point_valid``; the decorations are parameter-free and carry no
gradient; the two maxima back-propagate through the K2 / K1 gradients
of ``ops/segment.py``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VFEConfig, VoxelConfig

from ..ops.segment import segment_broadcast, segment_reduce
from ..ops.voxelize import Scene, low_voxel_coords
from .norm import MaskedBatchNorm


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (f32 parameters cast
    at use, as flax's ``Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class DynamicVFELayer(nn.Module):
    """Linear (no bias) + BN + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, bn_eps: float,
                 device=None):
        super().__init__()
        self.linear = Linear(in_channels, out_channels, bias=False,
                             device=device)
        self.norm = MaskedBatchNorm(out_channels, eps=bn_eps, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(self.linear(x), mask))


def decorated_width(cfg: VFEConfig) -> int:
    """The first layer's input width: the point features and the
    decorations that ``cfg`` asks for."""
    return (cfg.in_channels + 3 * (cfg.with_cluster_center
                                   + cfg.with_voxel_center)
            + cfg.with_distance)


def point_layers(cfg: VFEConfig, in_ch: int, device=None) -> nn.ModuleList:
    """One ``DynamicVFELayer`` per ``cfg.feat_channels``; every layer but
    the first sees its input concat its max."""
    chans = list(cfg.feat_channels)
    return nn.ModuleList(
        DynamicVFELayer(in_ch if i == 0 else 2 * chans[i - 1], ch,
                        cfg.bn_eps, device)
        for i, ch in enumerate(chans))


class DynamicScatterVFE(nn.Module):
    # the layers' name in the reference checkpoint
    LAYERS = "vfe_layers"

    def __init__(self, cfg: VFEConfig, voxel: VoxelConfig, device=None):
        super().__init__()
        self.cfg, self.voxel = cfg, voxel
        setattr(self, self.LAYERS,
                point_layers(cfg, decorated_width(cfg), device))

    @torch.no_grad()
    def decorations(self, scene: Scene) -> torch.Tensor:
        """[B, P, ``decorated_width(cfg)``] f32 point features with the
        cluster and pillar-centre offsets (and the distance,
        ``with_distance``), 0 on invalid points."""
        points, valid = scene.points, scene.valid
        p2v = scene.table.point2voxel
        v_cap = scene.table.valid.shape[-1]
        xyz = points[..., :3]
        feats = [points]
        if self.cfg.with_cluster_center:
            d = torch.where(valid[..., None], xyz, 0.0).float()
            pmean = segment_broadcast(d, p2v, v_cap, "mean")
            feats.append(xyz - pmean.to(points.dtype))
        if self.cfg.with_voxel_center:
            # pillar centres from each point's own coords (the table row's
            # formula); overflow and sentinel points read pillar 0
            _, ry, rx = self.voxel.sub_voxel_ratio_low
            low = low_voxel_coords(xyz, self.voxel)
            incap = p2v < v_cap
            py = torch.where(incap, low[..., 1] // ry, 0).to(points.dtype)
            px = torch.where(incap, low[..., 2] // rx, 0).to(points.dtype)
            r = self.voxel.point_cloud_range
            vx, vy, vz = self.voxel.voxel_size
            feats.append(torch.stack([
                points[..., 0] - (px * vx + (vx / 2 + r[0])),
                points[..., 1] - (py * vy + (vy / 2 + r[1])),
                points[..., 2] - (vz / 2 + r[2]),
            ], -1))
        if self.cfg.with_distance:
            feats.append(torch.sqrt((xyz * xyz).sum(-1, keepdim=True)))
        x = torch.cat(feats, -1)
        return torch.where(valid[..., None], x, 0.0)

    def forward(self, scene: Scene, dtype: torch.dtype) -> torch.Tensor:
        """Voxel features [B, V, feat_channels[-1]] in ``dtype``."""
        table = scene.table
        p2v = table.point2voxel
        v_cap = table.valid.shape[-1]
        pv = scene.valid[..., None]
        x = self.decorations(scene).to(dtype)
        layers = getattr(self, self.LAYERS)
        last = len(layers) - 1
        for i, layer in enumerate(layers):
            x = layer(x, scene.valid)
            if i != last:
                mb = segment_broadcast(x, p2v, v_cap, "max")
                x = torch.cat([x, torch.where(pv, mb, 0.0).to(dtype)], -1)
        vmax = segment_reduce(x, p2v, v_cap, "max")
        return torch.where(table.valid[..., None], vmax, 0.0).to(dtype)
