"""Metrics logging: a text log on stdout and in ``train.log`` plus a
``metrics.jsonl`` file.

Port of ``geomae_tpu/utils/logging.py`` (``get_root_logger``,
``MetricsLogger``, ``collect_env``); ``collect_env`` reports torch, its
CUDA build and the card instead of JAX and its devices.  In a
data-parallel run rank 0 alone writes ``train.log`` and
``metrics.jsonl``; the other ranks log errors only, as mmcv's root
logger does.
"""
from __future__ import annotations

import json
import logging
import os
import platform
import sys
import time
from typing import Dict, Optional

import torch

_NAME = "geomae_tpu_torch"
_FMT = f"%(asctime)s - {_NAME} - %(levelname)s - %(message)s"


def get_root_logger(log_file: Optional[str] = None,
                    level: int = logging.INFO,
                    rank: int = 0) -> logging.Logger:
    """The package's logger, writing to stdout and, where ``log_file`` is
    given, to that file: a handler for another file is closed and
    replaced, so each run in a process logs into its own work dir.  On a
    rank other than 0 it opens no file and passes errors only."""
    logger = logging.getLogger(_NAME)
    if not logger.handlers:
        logger.setLevel(level)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(sh)
    if rank != 0:
        logger.setLevel(logging.ERROR)
        return logger
    if log_file:
        logger.setLevel(level)
        path = os.path.abspath(log_file)
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FMT))
            logger.addHandler(fh)
    return logger


class MetricsLogger:
    """Logs loss dicts every ``interval`` steps: a text line and one
    ``metrics.jsonl`` row with ``step``, ``iter_time`` and ``mode`` (train
    or val).  On a rank other than 0 it writes nothing."""

    def __init__(self, work_dir: str, interval: int = 50, rank: int = 0):
        self.interval = interval
        self.rank = rank
        self.logger = get_root_logger(os.path.join(work_dir, "train.log"),
                                      rank=rank)
        self.path = os.path.join(work_dir, "metrics.jsonl")
        if rank == 0:
            open(self.path, "a").close()   # present even before a row
        self._t0 = time.perf_counter()
        self._last_step = 0

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train",
            force: bool = False) -> None:
        """``metrics`` values may be tensors on the device: they are read
        (a device synchronisation) only on the steps that log."""
        if self.rank != 0 or (step % self.interval and not force):
            return
        now = time.perf_counter()
        it_time = (now - self._t0) / max(step - self._last_step, 1)
        self._t0, self._last_step = now, step
        vals = {k: float(v) for k, v in metrics.items()}
        vals.update(step=step, iter_time=round(it_time, 4), mode=prefix)
        with open(self.path, "a") as f:
            f.write(json.dumps(vals) + "\n")
        msg = ", ".join(f"{k}: {v:.4f}" for k, v in vals.items()
                        if isinstance(v, float))
        self.logger.info("[%s] step %d: %s", prefix, step, msg)


def collect_env() -> Dict[str, str]:
    """Environment fingerprint: python, platform, torch, its CUDA build
    and the visible cards."""
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "devices": "cpu only",
    }
    if torch.cuda.is_available():
        info["devices"] = ", ".join(
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count()))
    return info
