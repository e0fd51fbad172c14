"""Normalization layers of the serving path.

Port of ``geomae_tpu/models/norm.py`` in eval mode.  The batch norms
subclass torch's so their parameters and buffers carry the reference
checkpoint's names (weight, bias, running_mean, running_var,
num_batches_tracked); their masked, cross-replica training statistics are
not ported yet, so they refuse to run in training mode.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.ffn import fast_layer_norm


def _folded_affine(bn: nn.modules.batchnorm._BatchNorm, dtype: torch.dtype):
    """(a, b) with ``bn(x) = x * a + b``: f32 statistics folded, then cast
    to the compute dtype (``MaskedBatchNorm`` in eval mode)."""
    if bn.training:
        raise NotImplementedError(
            f"{type(bn).__name__}: only eval mode (running statistics) is "
            "ported")
    inv = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    b = bn.bias - bn.running_mean * bn.weight * inv
    return (bn.weight * inv).to(dtype), b.to(dtype)


class MaskedBatchNorm(nn.BatchNorm1d):
    """Batch norm over the last axis of ``x`` [..., C]."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.01, device=None):
        super().__init__(features, eps=eps, momentum=momentum, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = _folded_affine(self, x.dtype)
        return x * a + b


class MaskedBatchNorm2d(nn.BatchNorm2d):
    """Batch norm over the channels of an NCHW map."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.01, device=None):
        super().__init__(features, eps=eps, momentum=momentum, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = _folded_affine(self, x.dtype)
        return x * a[:, None, None] + b[:, None, None]


class FastLayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics (``var = E[x^2] - mu^2``), output in
    x's dtype.  In the SST layers its parameters feed the fused
    post-attention kernel (``ops/ffn.py``), which applies it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fast_layer_norm(x, self.weight, self.bias, self.eps)
