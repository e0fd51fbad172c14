"""Eval CLI of the port: the counterpart of ``tools/test.py``.

    # score a fine-tune run on the nuScenes val infos, results JSON too
    python -m geomae_tpu_torch.test --work-dir work_dirs/ft \\
        --data-root data/nuscenes --ann-file nuscenes_infos_val.pkl \\
        --out work_dirs/ft/results_nusc.json

    # the tiny model on the CPU, weighted NMS, 8 frames
    python -m geomae_tpu_torch.test --work-dir /tmp/ft --tiny --device cpu \\
        --data-root /tmp/nus --ann-file infos.pkl --max-frames 8 --wnms

    # KITTI-format infos: the KITTI AP_R40 or the Waymo AP/APH protocol
    python -m geomae_tpu_torch.test --work-dir work_dirs/ft \\
        --dataset waymo --data-root data/waymo \\
        --ann-file waymo_infos_val.pkl --cfg-options data.load_dim=6

Restores the fine-tune checkpoint under ``--work-dir``/ckpt
(``train/checkpoint.py``) into the anchor-head config
(``geomae_finetune_nus()``, ``--tiny``: ``tiny_finetune_config()``, then
``--cfg-options``), predicts over the test-mode dataset in batches of
``--batch-size`` (the last batch padded with its last frame) with hard
NMS, or weighted NMS with ``--wnms``, and scores the predictions: nuScenes
mAP / NDS (``eval/nuscenes_eval.py``), KITTI AP_R40
(``eval/kitti_eval.py``) or Waymo AP / APH (``eval/waymo_eval.py``).
``--out`` writes the nuScenes results JSON.  The KITTI-format sets read
``data.load_dim`` / ``data.use_dim`` channels, as the train CLI does
(Waymo's 6-channel bins: ``--cfg-options data.load_dim=6``; the JAX CLI
reads the datasets' defaults, and its KITTI set then fails on 4-channel
points), and a predicted class outside Car, Pedestrian and Cyclist is
dropped before scoring (the JAX CLI raises on it).  Runs on
``--device cuda`` unless told otherwise.  Under ``torchrun`` each rank
predicts every world-th frame from its rank on, the ranks' rows are
gathered (``parallel.distributed.gather_results``), and rank 0 writes and
prints.
The CenterHead's detections are scored in process through
``eval.nuscenes_eval.evaluate``, as in the JAX package, whose CLI takes
no preset.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import config as C
from .data.nuscenes import NUS_CLASSES, NuScenesDetDataset
from .data.waymo import WAYMO_CLASSES, KittiDataset, WaymoDataset
from .eval.kitti_eval import evaluate_kitti
from .eval.nuscenes_eval import evaluate, format_results_json
from .eval.waymo_eval import evaluate_waymo
from .parallel.distributed import gather_results
from .parallel.mesh import init_distributed
from .train import finetune as FT
from .train.checkpoint import CheckpointManager


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m geomae_tpu_torch.test",
                                description="geomae_tpu_torch eval")
    p.add_argument("--work-dir", required=True,
                   help="train work dir holding ckpt/")
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--ann-file", default="nuscenes_infos_val.pkl")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--out", default=None, help="results JSON path")
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--wnms", action="store_true",
                   help="weighted NMS (score-weighted box voting) instead "
                        "of hard NMS at test time (reference wnms_cpu)")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   metavar="KEY=VAL",
                   help="dotted-path config overrides (mmcv --cfg-options)")
    p.add_argument("--dataset", default="nuscenes",
                   choices=["nuscenes", "kitti", "waymo"],
                   help="dataset family; kitti scores with the KITTI "
                        "AP_R40 protocol, waymo with the Waymo AP/APH "
                        "protocol (eval/waymo_eval.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model")
    return p.parse_args(argv)


def _names(frame: Dict) -> Dict:
    """``frame`` with a class name per box; a box whose label has no name
    (a class of the nuScenes head) is dropped: no protocol scores it."""
    keep = np.asarray(frame["labels"]) < len(WAYMO_CLASSES)
    out = {k: np.asarray(v)[keep] for k, v in frame.items()}
    out["names"] = np.asarray([WAYMO_CLASSES[int(lab)]
                               for lab in out["labels"]], dtype=object)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Parse ``argv`` (default: the command line), predict, score; returns
    the metrics (every rank, under ``torchrun``)."""
    args = parse_args(argv)
    cfg = C.tiny_finetune_config() if args.tiny else C.geomae_finetune_nus()
    if args.cfg_options:
        cfg = C.apply_overrides(cfg, args.cfg_options)
    cfg = C.replace(cfg, data=C.replace(cfg.data, data_root=args.data_root,
                                        ann_file=args.ann_file))

    if args.dataset == "nuscenes":
        ds = NuScenesDetDataset(cfg.data, cfg.voxel, cfg.caps,
                                cfg.max_gt_boxes, test_mode=True)
    else:
        cls = KittiDataset if args.dataset == "kitti" else WaymoDataset
        ds = cls(cfg.data, cfg.voxel, cfg.caps, cfg.max_gt_boxes,
                 test_mode=True, load_dims=cfg.data.load_dim,
                 use_dims=cfg.data.use_dim)
    n = len(ds) if args.max_frames is None else min(args.max_frames, len(ds))

    group = init_distributed(args.device) if "WORLD_SIZE" in os.environ \
        else None
    try:
        return _run(args, cfg, ds, n, group)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _run(args, cfg, ds, n: int, group) -> Dict[str, float]:
    device = args.device if group is None else group.device
    rank, world = (0, 1) if group is None else (group.rank, group.world)
    state = FT.init_state(cfg, device, torch.Generator().manual_seed(0))
    state = CheckpointManager(os.path.join(args.work_dir, "ckpt")).restore(
        state)
    predict = FT.make_predict_fn(cfg, wnms=args.wnms)

    my_frames = list(range(rank, n, world))
    rows = []                                    # (token, pred, gt) triples
    bs = args.batch_size
    t0 = time.perf_counter()
    for start in range(0, len(my_frames), bs):
        idxs = my_frames[start:start + bs]
        n_real = len(idxs)
        idxs += [idxs[-1]] * (bs - n_real)
        samples = [ds.__getitem__(i, seed=0) for i in idxs]
        batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                 .to(device) for k in ("points", "point_valid")}
        det = predict(state, batch)
        det = [t.cpu().numpy() for t in det]
        for j, i in enumerate(idxs[:n_real]):
            v = det[3][j]
            pred = dict(boxes=det[0][j][v], scores=det[1][j][v],
                        labels=det[2][j][v])
            b, lab = ds.get_ann(i)
            rows.append((ds.infos[i].get("token", str(i)), pred,
                         dict(boxes=b, labels=lab)))
    seconds = time.perf_counter() - t0
    rows = gather_results(rows, group)
    tokens = [r[0] for r in rows]
    preds = [r[1] for r in rows]
    gts = [r[2] for r in rows]
    if rank == 0:
        print(f"predicted {len(my_frames)} frames on {device} in "
              f"{seconds:.2f} s ({1e3 * seconds / max(len(my_frames), 1):.1f}"
              f" ms a frame, data included), {len(rows)} frames in all")

    if args.out and rank == 0:
        payload = format_results_json(tokens, preds, NUS_CLASSES)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f)
        print(f"wrote {args.out}")
    metrics: Dict[str, float] = {}
    if args.eval:
        if args.dataset == "nuscenes":
            metrics = evaluate(preds, gts, NUS_CLASSES)
        elif args.dataset == "waymo":
            # infos without per-GT point counts score everything as LEVEL_1
            metrics = evaluate_waymo([_names(p) for p in preds],
                                     [_names(g) for g in gts],
                                     classes=WAYMO_CLASSES)
        else:
            metrics = evaluate_kitti([_names(p) for p in preds],
                                     [_names(g) for g in gts])
        if rank == 0:
            print(json.dumps({k: round(v, 4) for k, v in metrics.items()},
                             indent=2))
    return metrics


if __name__ == "__main__":
    main()
