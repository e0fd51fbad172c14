"""The process group of a data-parallel run and each rank's batch shard.

Counterpart of ``geomae_tpu/parallel/mesh.py``.  The JAX package shards
the batch over a device mesh and lets XLA insert the collectives; here
each rank is a process that holds a replica of the model and its rows
of the global batch, and the train steps call the collectives
themselves (``parallel/distributed.py``).  ``torchrun`` starts the
processes and sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; a run
without them has no group (``None``), one process on the whole batch.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """This process's place in the default process group: its rank, the
    number of ranks, and the device that holds its replica."""
    rank: int
    world: int
    device: torch.device


def init_distributed(device: str = "cuda",
                     init_method: str = "env://") -> Group:
    """Join the default process group that ``RANK`` / ``WORLD_SIZE`` (and
    ``MASTER_ADDR`` / ``MASTER_PORT`` for ``env://``) describe.

    ``device="cuda"``: NCCL, the replica on ``cuda:LOCAL_RANK``; raises
    if NCCL is not available, with no fall-back to another backend.
    ``device="cpu"``: gloo.
    """
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("a CUDA run needs NCCL and a card; this "
                               "torch has neither or not both")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return Group(rank=rank, world=world, device=dev)


def shard_batch(batch: Mapping, rank: int, world: int) -> dict:
    """Rows ``[rank * b, (rank + 1) * b)`` of every entry of a global
    batch of ``world * b`` rows."""
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch entries differ in rows: {sorted(sizes)}")
    rows = sizes.pop()
    if rows % world:
        raise ValueError(f"a global batch of {rows} does not divide over "
                         f"{world} ranks")
    b = rows // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
