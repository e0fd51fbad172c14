"""Checkpoint and resume on ``torch.save`` / ``torch.load``.

Counterpart of ``geomae_tpu/train/checkpoint.py`` (orbax there): full-
state checkpoints every N steps with retention, a weights-only export,
and ``load_weights``, which takes whatever checkpoint the user points at.
A full-state checkpoint is one file ``<directory>/<step>.pt`` holding
``{"step", "model": state_dict, "optim": AdamW.state_dict()}``; a weights
file holds ``{"state_dict": ...}`` or a bare ``state_dict``.  Files are
written under a temporary name and renamed, so an interrupted save leaves
no half-written checkpoint, and they are read with ``weights_only=True``
(tensors, numbers, lists and dicts only).  In a data-parallel run rank
0 alone writes, and every rank waits at a barrier after each save; every
rank restores from the file onto its own device.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from ..parallel.distributed import barrier
from ..parallel.mesh import Group
from .state import TrainState


def _write(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: str) -> List[int]:
    return sorted(int(f[:-3]) for f in os.listdir(directory)
                  if f.endswith(".pt") and f[:-3].isdigit())


class CheckpointManager:
    """Saves a ``TrainState`` every ``save_interval_steps`` steps into
    ``directory`` and keeps the newest ``max_to_keep``; with ``group``,
    rank 0 writes and the ranks meet at a barrier after each save."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1000,
                 group: Optional[Group] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.group = group

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Write ``state`` if its step is a multiple of the interval (or
        ``force``) and not saved already; True when a file was written.
        Every rank decides alike from the step alone, so that all of them
        reach the barrier."""
        step = int(state.step)
        if not force and step % self.save_interval_steps:
            return False
        wrote = False
        if (self.group is None or self.group.rank == 0) \
                and step not in self.all_steps():
            _write({"step": step, "model": state.model.state_dict(),
                    "optim": state.tx.state_dict()}, self.path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
            wrote = True
        barrier(self.group)
        return wrote

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Fill ``state`` (its model, optimizer moments, update count and
        step) in place from checkpoint ``step`` (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        obj = torch.load(self.path(step), map_location=device,
                         weights_only=True)
        state.model.load_state_dict(obj["model"], strict=True)
        state.tx.load_state_dict(obj["optim"])
        state.step = int(obj["step"])
        return state


def save_weights(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Weights-only export: ``{"state_dict": ...}``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write({"state_dict": dict(state_dict)}, path)


def _resolve(path: str) -> str:
    """``path`` itself when it is a file; the latest ``<step>.pt`` when
    it is a trainer's checkpoint directory."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = os.path.join(path, f"{steps[-1]}.pt")
    return path


def load_weights(path: str, device: torch.device | str = "cuda"
                 ) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` on ``device`` from any of: a weights-only
    export (or a bare ``state_dict`` file, as the reference checkpoints
    are), a trainer ``ckpt/`` directory (its latest step), or one step's
    file."""
    obj = torch.load(_resolve(path), map_location=device, weights_only=True)
    for key in ("model", "state_dict"):
        if key in obj and isinstance(obj[key], dict):
            return obj[key]
    return obj
