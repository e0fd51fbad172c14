"""AdamW with global-norm clipping, the cyclic schedules and the decay
mask.

Port of ``geomae_tpu/train/optim.py``: ``optax.chain(
clip_by_global_norm(max_norm), inject_hyperparams(adamw)(lr=cyclic,
b1=cyclic momentum))`` with weight decay off for every normalization
parameter.

* The clip scales by ``max_norm / global_norm`` when the norm reaches
  max_norm, with no epsilon, as optax does (``clip_grad_norm_`` would
  add 1e-6).
* The lr and beta1 of update t (from 0) are the schedules' values at t;
  the bias correction of the first moment takes the current beta1,
  ``mu / (1 - beta1_t ** (t + 1))``, as optax's injected adam does.
* The JAX mask drops every flax path containing "norm" (the LayerNorms
  and, through their ``MaskedBatchNorm`` scopes, every BatchNorm) and the
  GeoMAE ``mask_token``.  Here the names (``backbone.conv_blocks.0.1.
  weight``) do not say "norm", so that part of the mask comes from the
  module types: no decay for the parameters of any BatchNorm or
  LayerNorm, nor for a parameter named ``mask_token``.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ..config import OptimConfig

from .schedules import cyclic_momentum_schedule, cyclic_schedule

_NORMS = (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)


def decay_mask(model: nn.Module) -> List[bool]:
    """For each of ``model.parameters()`` in order: True where weight decay
    applies."""
    no_decay = {id(p) for m in model.modules() if isinstance(m, _NORMS)
                for p in m.parameters(recurse=False)}
    no_decay |= {id(p) for name, p in model.named_parameters()
                 if name.rsplit(".", 1)[-1] == "mask_token"}
    return [id(p) not in no_decay for p in model.parameters()]


class AdamW:
    """The optimizer of ``make_optimizer(cfg)``, over ``model``'s
    parameters (f32 moments, the parameters' own dtype)."""

    def __init__(self, model: nn.Module, cfg: OptimConfig):
        self.cfg = cfg
        self.params = list(model.parameters())
        mask = decay_mask(model) if cfg.no_decay_norm else \
            [True] * len(self.params)
        self.decay = [p for p, m in zip(self.params, mask) if m]
        self.lr = cyclic_schedule(cfg.lr, cfg.target_ratio,
                                  cfg.step_ratio_up, cfg.total_steps)
        if cfg.momentum_ratio is None:
            self.b1 = lambda step: cfg.betas[0]
        else:
            self.b1 = cyclic_momentum_schedule(
                cfg.betas[0], cfg.momentum_ratio, cfg.step_ratio_up,
                cfg.total_steps)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def state_dict(self) -> dict:
        """The moments (in ``model.parameters()`` order) and the update
        count, for a checkpoint."""
        return {"mu": list(self.mu), "nu": list(self.nu),
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a ``state_dict()`` into this optimizer's own tensors."""
        for own, saved in ((self.mu, sd["mu"]), (self.nu, sd["nu"])):
            if [t.shape for t in own] != [t.shape for t in saved]:
                raise ValueError("optimizer moments do not match the model")
            for a, b in zip(own, saved):
                a.copy_(b)
        self.count = int(sd["count"])

    @torch.no_grad()
    def clip(self) -> torch.Tensor:
        """Scale the gradients to global norm ``grad_clip_norm`` if they
        reach it; returns the norm before clipping."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        if not bool(norm < self.cfg.grad_clip_norm):
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.cfg.grad_clip_norm)
        return norm

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (None counts as 0);
        returns the gradients' global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = self.clip()
        grads = [p.grad for p in self.params]
        lr, b1, b2 = self.lr(self.count), self.b1(self.count), \
            self.cfg.betas[1]
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        den = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        upd = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        torch._foreach_div_(upd, den)
        byid = dict(zip(map(id, self.params), upd))
        torch._foreach_add_([byid[id(p)] for p in self.decay], self.decay,
                            alpha=self.cfg.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        return norm
