"""The train state shared by the pretrain and the fine-tune task.

Counterpart of ``geomae_tpu/train/state.py``: where the JAX state holds
parameter, batch-statistics and optimizer trees, this one holds the
module (parameters and BN statistics) and the optimizer object, both
updated in place by the step functions.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.nn as nn

from .optim import AdamW


@dataclass
class TrainState:
    """The model (parameters and BN statistics), the optimizer (moments
    and its update count) and the step counter."""
    step: int
    model: nn.Module
    tx: AdamW
