"""Train CLI of the port: the counterpart of ``tools/train.py``.

    # GeoMAE pretrain on generated scenes, tiny model, on the CPU
    python -m geomae_tpu_torch.train pretrain --synthetic --tiny \\
        --device cpu --total-steps 3 --batch-size 2 --work-dir /tmp/pre
    # run it again with --total-steps 5: the log says "resumed from step 3"

    # detection fine-tune from that pretrain checkpoint
    python -m geomae_tpu_torch.train finetune --synthetic --tiny \\
        --device cpu --total-steps 2 --batch-size 2 \\
        --load-from /tmp/pre/ckpt --work-dir /tmp/ft

    # GeoMAE pretrain on nuScenes SSL infos on disk (the native point prep)
    python -m geomae_tpu_torch.train pretrain --data-root data/nuscenes \\
        --ann-file nuscenes_ssl_infos_train.pkl --work-dir work_dirs/pre

    # detection fine-tune on nuScenes infos, class-balanced (CBGS, the
    # default at full width), from the pretrain checkpoint
    python -m geomae_tpu_torch.train finetune --data-root data/nuscenes \\
        --ann-file nuscenes_infos_train.pkl --cbgs \\
        --load-from work_dirs/pre/ckpt --work-dir work_dirs/ft

    # the CenterHead variant (0.256 m pillars, SECOND [3, 5], 6 tasks)
    python -m geomae_tpu_torch.train finetune --preset nus_centerhead \
        --data-root data/nuscenes --ann-file nuscenes_infos_train.pkl \
        --load-from work_dirs/pre/ckpt --work-dir work_dirs/ft_center

    # Waymo multi-sweep pretrain on KITTI-format infos (6-channel bins)
    python -m geomae_tpu_torch.train pretrain --preset waymo \\
        --data-root data/waymo --ann-file waymo_infos_train.pkl

    # full width on a CUDA GPU, the K8 attention route
    python -m geomae_tpu_torch.train pretrain --synthetic \\
        --cfg-options sst.attention_impl=band --total-steps 20

    # data parallel over 8 GPUs of one host (global batch 32)
    torchrun --nproc_per_node 8 -m geomae_tpu_torch.train pretrain \\
        --synthetic --total-steps 20

Runs on ``--device cuda`` unless told otherwise.  Under ``torchrun``
(``RANK`` / ``WORLD_SIZE`` set) each process joins a process group (NCCL
on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and trains its rows
of every global batch; ``--batch-size`` is the global batch, by default
the config's per-device batch times the number of ranks, and must divide
by it.

Datasets as ``tools/train.py`` picks them: pretrain reads
``NuScenesSSLDataset`` (``--preset waymo``: ``WaymoSSLDataset``),
fine-tune ``NuScenesDetDataset``, wrapped in ``CBGSDataset`` unless
``--tiny`` or ``--cbgs`` says otherwise (``--preset waymo``:
``WaymoDataset``, on the nuScenes fine-tune config, as the JAX CLI does;
its 6-channel bins then need ``--cfg-options data.load_dim=6``).
``--preset nus_centerhead`` fine-tunes ``geomae_finetune_nus_centerhead()``
(``--tiny``: ``tiny_finetune_center_config()``) on the same nuScenes
sets; its pretrain is the nuScenes one.  Without ``--data-root`` the
config's own ``data.data_root`` is read (the Waymo preset's
``data/waymo``), where ``tools/train.py`` defaults to ``data/nuscenes``
for every preset.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import config as C
from ..data.loader import PrefetchLoader
from ..data.nuscenes import (CBGSDataset, NuScenesDetDataset,
                             NuScenesSSLDataset)
from ..data.synthetic import SyntheticDet, SyntheticSSL
from ..data.waymo import WaymoDataset, WaymoSSLDataset
from ..parallel.mesh import Group, init_distributed, shard_batch
from ..utils.logging import get_root_logger
from .trainer import Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m geomae_tpu_torch.train",
                                description="geomae_tpu_torch trainer")
    p.add_argument("task", choices=["pretrain", "finetune"])
    p.add_argument("--preset", default="nus",
                   choices=["nus", "waymo", "nus_centerhead"],
                   help="config family (dataset geometry + model variant)")
    p.add_argument("--work-dir", default="work_dirs/run")
    p.add_argument("--data-root", default=None,
                   help="dataset root on disk (default: the config's "
                        "data.data_root)")
    p.add_argument("--ann-file", default=None,
                   help="info pickle under --data-root (default: the "
                        "config's data.ann_file)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (default: the config's, 4, per "
                        "rank)")
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--load-from", default=None,
                   help="weights-only init (fine-tune from a pretrain "
                        "checkpoint: a weights file, a ckpt/ directory or "
                        "one step's file)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated scenes (smoke tests)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (CPU-friendly)")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--cbgs", action="store_true", default=None,
                   help="class-balanced resampling of the nuScenes "
                        "fine-tune set (default: on unless --tiny)")
    p.add_argument("--log-interval", type=int, default=50,
                   help="log the losses every N steps")
    p.add_argument("--ckpt-interval", type=int, default=1000,
                   help="checkpoint every N steps (and at the end)")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="run the eval hook every N steps (0 = off)")
    p.add_argument("--eval-frames", type=int, default=8,
                   help="frames per eval-hook pass")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the steps")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   metavar="KEY=VAL",
                   help="dotted-path config overrides, e.g. "
                        "optim.lr=3e-5 sst.attention_impl=band "
                        "voxel.voxel_size=0.2,0.2,8")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv`` (default: the command line), train, and return the
    finished ``Trainer``; under ``torchrun`` every rank calls it."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    # the run's log from the start, so that the weight import lands in it
    get_root_logger(os.path.join(args.work_dir, "train.log"), rank=rank)
    pretrain = args.task == "pretrain"
    waymo = args.preset == "waymo"
    if pretrain and waymo:
        cfg = C.tiny_pretrain_waymo_config() if args.tiny \
            else C.geomae_pretrain_waymo()
    elif pretrain:
        cfg = C.tiny_pretrain_config() if args.tiny \
            else C.geomae_pretrain_nus()
    elif args.preset == "nus_centerhead":
        cfg = C.tiny_finetune_center_config() if args.tiny \
            else C.geomae_finetune_nus_centerhead()
    else:
        cfg = C.tiny_finetune_config() if args.tiny \
            else C.geomae_finetune_nus()
    if args.data_root or args.ann_file:
        cfg = C.replace(cfg, data=C.replace(
            cfg.data, data_root=args.data_root or cfg.data.data_root,
            ann_file=args.ann_file or cfg.data.ann_file))
    if args.cfg_options:
        cfg = C.apply_overrides(cfg, args.cfg_options)

    batch = args.batch_size or cfg.data.batch_size * world
    if batch % world:
        raise ValueError(f"--batch-size {batch} (the global batch) does not "
                         f"divide over {world} ranks")
    ds = dataset(args, cfg, pretrain, waymo)
    steps_per_epoch = max(len(ds) // batch, 1)
    if args.total_steps:
        total = args.total_steps
    else:
        total = steps_per_epoch * (args.epochs or (72 if pretrain else 20))
    cfg = C.replace(cfg, optim=C.replace(cfg.optim, total_steps=total))

    group = init_distributed(args.device) if "WORLD_SIZE" in os.environ \
        else None
    try:
        return _train(args, cfg, pretrain, ds, batch, total, group)
    finally:
        if group is not None:
            dist.destroy_process_group()


def dataset(args, cfg, pretrain: bool, waymo: bool):
    """The training set ``tools/train.py`` builds for these arguments."""
    if args.synthetic:
        return (SyntheticSSL if pretrain else SyntheticDet)(cfg)
    data, dims = cfg.data, dict(load_dims=cfg.data.load_dim,
                                use_dims=cfg.data.use_dim)
    if pretrain and waymo:
        return WaymoSSLDataset(data, cfg.voxel, cfg.caps, **dims)
    if pretrain:
        return NuScenesSSLDataset(data, cfg.voxel, cfg.caps)
    if waymo:
        return WaymoDataset(data, cfg.voxel, cfg.caps, cfg.max_gt_boxes,
                            **dims)
    ds = NuScenesDetDataset(data, cfg.voxel, cfg.caps, cfg.max_gt_boxes)
    if args.cbgs or (args.cbgs is None and not args.tiny):
        ds = CBGSDataset(ds)
    return ds


def _train(args, cfg, pretrain: bool, ds, batch: int, total: int,
           group: Optional[Group]) -> Trainer:
    device = args.device if group is None else group.device
    rank, world = (0, 1) if group is None else (group.rank, group.world)
    if group is not None:
        get_root_logger().info("process group: rank %d of %d, replica on %s",
                               rank, world, device)
    loader = PrefetchLoader(ds, batch, num_workers=args.num_workers,
                            seed=args.seed, rank=rank, world=world)
    gen = torch.Generator().manual_seed(args.seed)
    eval_fn = eval_loader = None
    if pretrain:
        from .pretrain import init_state, make_eval_hook, make_train_step
        state = init_state(cfg, device, gen)
        if args.eval_interval:
            eval_fn = make_eval_hook(cfg, group)
            n_eval = max(args.eval_frames // batch, 1)
            eval_loader = [shard_batch(
                {k: np.stack([ds.__getitem__((j * batch + i) % len(ds),
                                             seed=10**6)[k]
                              for i in range(batch)])
                 for k in ("points", "point_valid")}, rank, world)
                for j in range(n_eval)]
    else:
        from .checkpoint import load_weights
        from .finetune import init_state, make_train_step
        pre = load_weights(args.load_from, device) \
            if args.load_from else None
        state = init_state(cfg, device, gen, pretrain=pre)
    trainer = Trainer(make_train_step(cfg, group), state, loader,
                      args.work_dir, total, with_rng=pretrain, seed=args.seed,
                      log_interval=args.log_interval,
                      ckpt_interval=args.ckpt_interval,
                      resume=not args.no_resume, eval_fn=eval_fn,
                      eval_loader=eval_loader,
                      eval_interval=args.eval_interval, group=group)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
