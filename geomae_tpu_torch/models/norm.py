"""Normalization layers.

Port of ``geomae_tpu/models/norm.py``.  The batch norms subclass torch's
so their parameters and buffers carry the reference checkpoint's names
(weight, bias, running_mean, running_var, num_batches_tracked).

In eval mode the running statistics fold into one affine.  In training
mode (``MaskedBatchNorm.__call__(train=True)`` of the JAX package) the
statistics are masked one-pass f32 moments over the batch,
``mean = E[x]``, ``var = max(E[x^2] - E[x]^2, 0)``, differentiated
through like the JAX function; the running mean and var move by the
momentum (0.01) toward the batch mean and the unbiased batch var
``var * cnt / max(cnt - 1, 1)``, and ``num_batches_tracked`` counts the
updates.  Either way the normalize is one affine ``x * a + b`` in x's
dtype, with a and b computed in f32.  Inside
``parallel.distributed.data_parallel(group)`` the masked count, sum
and sum of squares are summed over the group's ranks in one
differentiable all-reduce before the moments, so every rank normalizes
with the whole batch's moments, its gradient flows through them, and
the running statistics stay bitwise equal across ranks: the JAX
package's global mean under ``jit`` over a mesh.  A rank whose mask is
all false still takes part.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.ffn import fast_layer_norm
from ..parallel.distributed import all_reduce_sum


def _normalize(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               mask: torch.Tensor | None, channel_dim: int) -> torch.Tensor:
    """``bn`` over ``x`` with channels on ``channel_dim``; ``mask`` (x's
    shape without the channel axis) selects the elements of the batch
    statistics, None for all."""
    if bn.training:
        xf = torch.movedim(x, channel_dim, -1).float()
        xf = xf.reshape(-1, xf.shape[-1])
        if mask is None:
            cnt = torch.tensor(float(xf.shape[0]), device=x.device)
            xm = xf
        else:
            m = mask.reshape(-1, 1).to(torch.float32)
            cnt = m.sum()
            xm = xf * m
        cnt, s1, s2 = all_reduce_sum(cnt, xm.sum(0), (xm * xf).sum(0))
        if mask is not None:
            cnt = cnt.clamp_min(1.0)
        mean = s1 / cnt
        var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
        with torch.no_grad():
            unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * unbiased)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    inv = 1.0 / torch.sqrt(var + bn.eps)
    a = (bn.weight * inv).to(x.dtype)
    b = (bn.bias - mean * bn.weight * inv).to(x.dtype)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return x * a.reshape(shape) + b.reshape(shape)


class MaskedBatchNorm(nn.BatchNorm1d):
    """Batch norm over the last axis of ``x`` [..., C]; in training, the
    statistics take the elements where ``mask`` [...] is set."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.01, device=None):
        super().__init__(features, eps=eps, momentum=momentum, device=device)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        return _normalize(self, x, mask, -1)


class MaskedBatchNorm2d(nn.BatchNorm2d):
    """Batch norm over the channels of an NCHW map (every element counts,
    the all-ones mask of the JAX package)."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.01, device=None):
        super().__init__(features, eps=eps, momentum=momentum, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _normalize(self, x, None, 1)


class FastLayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics (``var = E[x^2] - mu^2``), output in
    x's dtype.  In the SST layers its parameters feed the fused
    post-attention kernel (``ops/ffn.py``), which applies it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fast_layer_norm(x, self.weight, self.bias, self.eps)
