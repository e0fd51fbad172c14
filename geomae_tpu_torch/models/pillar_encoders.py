"""Classic voxel and pillar encoders of the reference zoo.

Port of ``geomae_tpu/models/pillar_encoders.py``: mmdet3d's
``HardSimpleVFE`` / ``DynamicSimpleVFE`` (``voxel_encoders/
voxel_encoder.py:19-89``), ``HardVFE`` (``voxel_encoder.py:422-585``) and
``PillarFeatureNet`` (``pillar_encoder.py:12-153``), the encoders of
``VoxelNet``.  ``PointPillarsScatter`` is ``second.recover_bev``.

``PillarFeatureNet`` runs on a pillar-sorted ``Scene`` through the
segment kernels: K2 mean for the cluster centre, K2 max to broadcast a
layer's pillar max back to its points, K1 max for the last layer's
pillar max; under grad their backward kernels (K2 sum, the K1 gather).
``dynamic_simple_vfe`` is one K1 sum.  ``HardVFE`` and
``hard_simple_vfe`` are plain torch over dense buffers, as their JAX
versions reach no Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..config import VFEConfig, VoxelConfig
from ..ops.segment import segment_reduce
from ..ops.voxelize import Scene
from .vfe import DynamicScatterVFE, decorated_width, point_layers


def hard_simple_vfe(voxels: torch.Tensor, num_points: torch.Tensor,
                    num_features: int = 4) -> torch.Tensor:
    """Mean of the points of each voxel of [..., V, T, D] hard-voxelized
    buffers, [..., V, num_features] (``HardSimpleVFE``)."""
    s = voxels[..., :num_features].sum(-2)
    return s / num_points.clamp_min(1)[..., None].to(s.dtype)


def dynamic_simple_vfe(scene: Scene, num_features: int = 4) -> torch.Tensor:
    """Mean of the points of each pillar row, [B, V, num_features] f32, 0
    on invalid rows (``DynamicSimpleVFE``): one K1 sum of the points and a
    count channel."""
    table = scene.table
    valid = scene.valid[..., None]
    pts = torch.where(valid, scene.points[..., :num_features], 0.0)
    s = segment_reduce(torch.cat([pts, valid.to(pts.dtype)], -1).float(),
                       table.point2voxel, table.valid.shape[-1], "sum")
    mean = s[..., :-1] / s[..., -1:].clamp_min(1.0)
    return torch.where(table.valid[..., None], mean, 0.0)


class HardVFE(nn.Module):
    """VFE over dense hard-voxelized buffers: each point decorated with its
    cluster-centre and pillar-centre offsets and its distance, then per
    layer Linear (no bias) + BN + ReLU and the max over the voxel's slots,
    concatenated back to the points on every layer but the last.

    Inputs are batched: ``voxels`` [B, V, T, D] from
    ``ops.voxelize.hard_voxelize``, ``num_points`` [B, V], ``coords`` [B,
    V, 2] (y, x).  As in the reference only the decorated input is masked
    (``voxel_encoder.py:575``): the BN statistics take the written slots,
    but the max also sees ``relu(BN(linear(0)))`` of the empty ones."""

    def __init__(self, cfg: VFEConfig, voxel: VoxelConfig, device=None):
        super().__init__()
        self.cfg, self.voxel = cfg, voxel
        self.vfe_layers = point_layers(cfg, decorated_width(cfg), device)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
        """Voxel features [B, V, feat_channels[-1]] in ``dtype``."""
        T = voxels.shape[2]
        mask = (torch.arange(T, device=voxels.device)[None, None, :]
                < num_points[..., None])                  # [B, V, T]
        xyz = voxels[..., :3]
        feats = [voxels]
        if self.cfg.with_cluster_center:
            mean = (xyz.sum(-2, keepdim=True)
                    / num_points.clamp_min(1)[..., None, None].to(xyz.dtype))
            feats.append(xyz - mean)
        if self.cfg.with_voxel_center:
            r = self.voxel.point_cloud_range
            vx, vy, vz = self.voxel.voxel_size
            cy = coords[..., 0:1].to(voxels.dtype)
            cx = coords[..., 1:2].to(voxels.dtype)
            feats.append(torch.stack([
                voxels[..., 0] - (cx * vx + vx / 2 + r[0]),
                voxels[..., 1] - (cy * vy + vy / 2 + r[1]),
                voxels[..., 2] - (vz / 2 + r[2])], -1))
        if self.cfg.with_distance:
            feats.append(torch.sqrt((xyz * xyz).sum(-1, keepdim=True)))
        x = torch.where(mask[..., None], torch.cat(feats, -1), 0.0).to(dtype)
        last = len(self.vfe_layers) - 1
        for i, layer in enumerate(self.vfe_layers):
            x = layer(x, mask)
            vmax = x.amax(-2)                             # [B, V, ch]
            if i != last:
                x = torch.cat([x, vmax[..., None, :].expand_as(x)], -1)
        return vmax


class PillarFeatureNet(DynamicScatterVFE):
    """The PointPillars encoder on a pillar-sorted scene: the decorated
    points through the PFN layers, each layer's pillar max concatenated
    back to its points, the last one's per pillar.  With a sorted pillar
    table the hard and dynamic reference encoders coincide, and so does
    the arithmetic of ``DynamicScatterVFE``; the layers carry the
    reference's names, ``pfn_layers.{i}.{linear,norm}``."""

    LAYERS = "pfn_layers"
