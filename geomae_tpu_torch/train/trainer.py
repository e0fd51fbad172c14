"""Training loop: the port's counterpart of ``geomae_tpu/train/trainer.py``.

The step function updates the state in place; a host-side prefetch
loader feeds it; the state is checkpointed every N steps and a relaunch
on the same work dir resumes from the latest checkpoint; metrics go to
``train.log`` and ``metrics.jsonl``.

Data parallelism, the JAX trainer's mesh: with a ``group``
(``parallel/mesh.py``) every rank runs a Trainer over its replica, a step
function made with that group and a loader of its rows.  The Trainer
broadcasts rank 0's parameters and buffers once at start, as DDP does;
rank 0 alone writes the checkpoints and logs; the eval hook's scalars
are averaged over the ranks.

The mask generator of step ``s`` (pretrain) is seeded from ``(seed, s)``
on every rank, so a resumed run draws the masks an uninterrupted run
would have drawn, and each rank takes its rows of one draw.  The JAX
trainer restarts its key stream from ``PRNGKey(seed)`` on resume.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ..parallel.distributed import broadcast_module, gather_scalar_mean
from ..parallel.mesh import Group
from ..utils.logging import MetricsLogger, collect_env, get_root_logger
from .checkpoint import CheckpointManager
from .state import TrainState


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The generator of train step ``step`` (counted from 0) under the
    run seed ``seed``, on ``device``."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (2 ** 63))


class Trainer:
    """Drives any ``(state, batch[, generator]) -> (state, metrics)`` step
    function.

    Args:
      step_fn: the train step (updates ``state`` in place).
      state: the initial TrainState; its model's device is the device the
        batches are copied to.
      loader: iterable of host batches, dicts of numpy arrays (re-iterated
        per epoch).
      work_dir: logs and checkpoints.
      with_rng: whether step_fn takes a per-step generator (pretrain does).
      eval_fn, eval_loader, eval_interval: ``eval_fn(state, eval_loader)``
        runs every ``eval_interval`` steps and once at the end.
      group: the data-parallel group of a multi-rank run, else None.

    ``timings`` collects, per step, the host milliseconds spent waiting
    for the next batch (``data``), in the step (``step``; on a CUDA device
    the optimizer's clip reads the gradient norm, so the step's device
    work has finished when it returns, all but the update itself) and in
    the checkpoint save (``ckpt``).
    """

    def __init__(self, step_fn: Callable, state: TrainState, loader: Iterable,
                 work_dir: str, total_steps: int, with_rng: bool = True,
                 seed: int = 0, log_interval: int = 50,
                 ckpt_interval: int = 1000, resume: bool = True,
                 eval_fn: Optional[Callable] = None, eval_loader=None,
                 eval_interval: int = 0, group: Optional[Group] = None):
        self.work_dir = os.path.abspath(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        self.group = group
        rank = 0 if group is None else group.rank
        self.logger = get_root_logger(os.path.join(self.work_dir, "train.log"),
                                      rank=rank)
        self.metrics = MetricsLogger(self.work_dir, log_interval, rank)
        self.step_fn = step_fn
        self.loader = loader
        self.total_steps = total_steps
        self.with_rng = with_rng
        self.seed = seed
        self.ckpt = CheckpointManager(os.path.join(self.work_dir, "ckpt"),
                                      save_interval_steps=ckpt_interval,
                                      group=group)
        self.eval_fn = eval_fn
        self.eval_loader = eval_loader
        self.eval_interval = eval_interval
        self.device = next(state.model.parameters()).device
        self.timings: Dict[str, list] = {"data": [], "step": [], "ckpt": []}

        if resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            self.logger.info("resumed from step %d", state.step)
        broadcast_module(state.model, group)
        self.state = state
        for k, v in collect_env().items():
            self.logger.info("env %s: %s", k, v)

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _prefetch(self, it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
        """Double-buffered device transfer: a batch is pinned and its
        copy to the card enqueued while the previous step still runs, so
        the transfer overlaps device compute."""
        q = collections.deque()
        for batch in it:
            q.append(self._to_device(batch))
            if len(q) >= depth:
                yield q.popleft()
        while q:
            yield q.popleft()

    def run(self) -> TrainState:
        step = self.state.step
        while step < self.total_steps:
            made_progress = False
            t0 = time.perf_counter()
            for batch in self._prefetch(iter(self.loader)):
                made_progress = True
                if step >= self.total_steps:
                    break
                t1 = time.perf_counter()
                if self.with_rng:
                    gen = step_generator(self.seed, step, self.device)
                    self.state, metrics = self.step_fn(self.state, batch, gen)
                else:
                    self.state, metrics = self.step_fn(self.state, batch)
                step += 1
                t2 = time.perf_counter()
                self.metrics.log(step, metrics)
                self.ckpt.save(self.state)
                t3 = time.perf_counter()
                for k, ms in (("data", t1 - t0), ("step", t2 - t1),
                              ("ckpt", t3 - t2)):
                    self.timings[k].append(1e3 * ms)
                if (self.eval_fn is not None and self.eval_interval
                        and step % self.eval_interval == 0):
                    self.evaluate(step)
                t0 = time.perf_counter()
            if not made_progress:
                raise RuntimeError(
                    "loader yielded no batches (dataset smaller than the "
                    "global batch?): training cannot make progress")
        if self.eval_fn is not None and (
                not self.eval_interval or step % self.eval_interval):
            self.evaluate(step)
        self.ckpt.save(self.state, force=True)
        if self.timings["step"]:
            self.logger.info("host ms per step, median: " + ", ".join(
                f"{k} {float(np.median(v)):.1f}"
                for k, v in self.timings.items()))
        self.logger.info("training done at step %d", step)
        return self.state

    def evaluate(self, step: int) -> dict:
        """Run the eval hook and log its scalars, averaged over the ranks,
        with mode ``val``."""
        results = self.eval_fn(self.state, self.eval_loader)
        scalars = {k: gather_scalar_mean(float(v), self.group)
                   for k, v in results.items()}
        self.metrics.log(step, scalars, prefix="val", force=True)
        self.logger.info(
            "eval @ step %d: %s", step,
            ", ".join(f"{k}={v:.4f}" for k, v in scalars.items()))
        return results
