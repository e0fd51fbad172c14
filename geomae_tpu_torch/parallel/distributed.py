"""Collectives of a data-parallel run.

Counterpart of ``geomae_tpu/parallel/distributed.py`` (``gather_results``,
``gather_scalar_mean``) and of the reductions XLA inserts under ``jit``
over the JAX package's mesh: the gradient sum, the batch norms' global
moments and the loss denominators.  The step-level functions take the
run's ``Group`` (``parallel/mesh.py``) or ``None``; the model's code
reads the group of the enclosing ``data_parallel`` block, which the
step sets.  Without a group every function is the identity, so a run
without one computes what it did before this module existed.  The
collectives run on the default process group.

Every rank calls the same collectives in the same order: the train
steps do so by construction, since the ranks run one program on
batches of one shape.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import Group

_GROUP: contextvars.ContextVar[Optional[Group]] = \
    contextvars.ContextVar("data_parallel_group", default=None)


@contextlib.contextmanager
def data_parallel(group: Optional[Group]) -> Iterator[None]:
    """Within the block, the model's reductions over the batch (the
    training-mode batch norms' moments, the mask draw, the loss
    denominators) cover ``group``'s whole batch.  A step sets it once
    around its forward and loss."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def current_group() -> Optional[Group]:
    """The group of the enclosing ``data_parallel`` block, if any."""
    return _GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is the same all-reduce of the
    cotangent: rank r's output is sum_s x_s, so d loss / d x_r sums the
    cotangents of every rank's output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(g)


def all_reduce_sum(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The sums of ``xs`` (tensors of one dtype) over the ranks of the
    enclosing ``data_parallel`` block, in one differentiable all-reduce;
    ``xs`` themselves outside one."""
    if current_group() is None:
        return xs
    flat = _AllReduceSum.apply(torch.cat([x.reshape(-1) for x in xs]))
    parts = flat.split([x.numel() for x in xs])
    return tuple(t.view_as(x) for t, x in zip(parts, xs))


@torch.no_grad()
def all_reduce_grads(model: nn.Module, group: Optional[Group]) -> None:
    """Replace every parameter's gradient by its sum over the ranks, in
    one SUM all-reduce of all gradients flattened in parameter order; a
    ``None`` gradient counts as zeros, so every rank sends one layout."""
    if group is None:
        return
    params = list(model.parameters())
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


@torch.no_grad()
def sum_losses(losses: Dict[str, torch.Tensor],
               group: Optional[Group]) -> Dict[str, torch.Tensor]:
    """The detached loss terms summed over the ranks in one all-reduce.
    Each rank's term divides its own numerator by the whole batch's
    denominator, so the sum is the whole batch's loss."""
    out = {k: v.detach() for k, v in losses.items()}
    if group is None:
        return out
    flat = torch.stack(list(out.values()))
    dist.all_reduce(flat)
    return dict(zip(out, flat.unbind()))


@torch.no_grad()
def broadcast_module(model: nn.Module, group: Optional[Group]) -> None:
    """Overwrite every parameter and buffer with rank 0's."""
    if group is None:
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t, 0)


def barrier(group: Optional[Group]) -> None:
    """Wait for every rank."""
    if group is not None:
        dist.barrier()


def gather_results(local: Sequence[Any], group: Optional[Group]) -> List[Any]:
    """Every rank's list of host results, concatenated in rank order, on
    every rank; ``list(local)`` without a group.  The lists may differ
    in length."""
    if group is None:
        return list(local)
    parts: List[Any] = [None] * group.world
    dist.all_gather_object(parts, list(local))
    return [x for part in parts for x in part]


def gather_scalar_mean(x: float, group: Optional[Group]) -> float:
    """The mean of a host scalar over the ranks (float64); ``float(x)``
    without a group."""
    if group is None:
        return float(x)
    parts: List[Any] = [None] * group.world
    dist.all_gather_object(parts, float(x))
    return float(np.mean(np.asarray(parts, np.float64)))
