"""Dense BEV stages in NCHW: recover_bev, SECOND conv stages, SECONDFPN.

Port of ``geomae_tpu/models/second.py``.  The JAX package keeps NHWC for
the TPU; here the maps are NCHW, PyTorch's and cuDNN's layout.  Stage i
is Conv3x3(stride, no bias) + BN + ReLU, then ``layer_nums[i]`` x
(Conv3x3 + BN + ReLU), as one ``nn.Sequential`` so its layers carry the
reference's ``conv_blocks.{i}.{index}`` names; each FPN level is
ConvTranspose(stride = upsample) + BN + ReLU (``deblocks.{i}.{0,1}``).
Convolutions run in their input's dtype.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import FPNConfig, SECONDConfig

from .norm import MaskedBatchNorm2d


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def recover_bev(voxel_feats: torch.Tensor, coords: torch.Tensor,
                valid: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """[B, V, C] pillar features + (y, x) coords -> [B, C, ny, nx] canvas,
    0 where no pillar; invalid rows write a trash column that is cut."""
    B, V, C = voxel_feats.shape
    key = torch.where(valid, coords[..., 0] * nx + coords[..., 1], ny * nx)
    canvas = voxel_feats.new_zeros((B, C, ny * nx + 1))
    canvas.scatter_(2, key.long()[:, None, :].expand(B, C, V),
                    voxel_feats.transpose(1, 2))
    return canvas[..., :-1].reshape(B, C, ny, nx)


def conv_bn_relu(cin: int, cout: int, stride: int, eps: float,
                 device=None) -> List[nn.Module]:
    """Conv3x3 (no bias) + BN + ReLU, as three layers of a Sequential."""
    return [Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                   device=device),
            MaskedBatchNorm2d(cout, eps=eps, device=device),
            nn.ReLU()]


class SECONDStages(nn.ModuleList):
    """The conv pyramid; ``forward`` returns one map per stage."""

    def __init__(self, cfg: SECONDConfig, device=None):
        stages, cin = [], cfg.in_channels
        for cout, n, s in zip(cfg.out_channels, cfg.layer_nums,
                              cfg.layer_strides):
            layers = conv_bn_relu(cin, cout, s, cfg.bn_eps, device)
            for _ in range(n):
                layers += conv_bn_relu(cout, cout, 1, cfg.bn_eps, device)
            stages.append(nn.Sequential(*layers))
            cin = cout
        super().__init__(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for stage in self:
            x = stage(x)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """Per-level upsample (transposed conv, or strided conv for strides
    below 1) + BN + ReLU, concatenated on channels."""

    def __init__(self, cfg: FPNConfig, device=None):
        super().__init__()
        blocks = []
        for cin, cout, us in zip(cfg.in_channels, cfg.out_channels,
                                 cfg.upsample_strides):
            if us >= 1:
                up = ConvTranspose2d(cin, cout, int(us), stride=int(us),
                                     bias=False, device=device)
            else:
                s = int(round(1 / us))
                up = Conv2d(cin, cout, s, stride=s, bias=False,
                            device=device)
            blocks.append(nn.Sequential(
                up, MaskedBatchNorm2d(cout, eps=cfg.bn_eps, device=device),
                nn.ReLU()))
        self.deblocks = nn.ModuleList(blocks)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([blk(x) for blk, x in zip(self.deblocks, feats)], 1)
