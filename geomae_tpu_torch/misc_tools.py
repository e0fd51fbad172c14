"""Miscellaneous tools, the port's counterpart of the JAX package's
``tools/misc_tools.py`` (the reference's ``tools/misc/print_config.py``,
``tools/misc/browse_dataset.py`` (textual), ``tools/model_converters/
publish_model.py``, ``tools/analysis_tools/analyze_logs.py`` and
``tools/misc/visualize_results.py``):

    python -m geomae_tpu_torch.misc_tools print_config finetune
    python -m geomae_tpu_torch.misc_tools publish_model --ckpt-dir work/ckpt \\
        --out work/weights.pth --task finetune
    python -m geomae_tpu_torch.misc_tools analyze_logs --log work/metrics.jsonl
    python -m geomae_tpu_torch.misc_tools browse_dataset --data-root data/nuscenes
    python -m geomae_tpu_torch.misc_tools visualize_results --ckpt-dir work/ckpt

``visualize_results`` serves on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pprint
from typing import Optional, Sequence

import numpy as np

from . import config as C


def print_config(args) -> None:
    cfg = {"pretrain": C.geomae_pretrain_nus,
           "finetune": C.geomae_finetune_nus,
           "tiny_pretrain": C.tiny_pretrain_config,
           "tiny_finetune": C.tiny_finetune_config}[args.config]()
    pprint.pprint(dataclasses.asdict(cfg))


def publish_model(args) -> None:
    """Strip the optimizer: a trainer's full-state checkpoint (its latest
    step) -> a weights-only file that ``apis.init_model`` loads."""
    from .train import finetune as FT
    from .train import pretrain as PT
    from .train.checkpoint import CheckpointManager, save_weights

    if args.task == "pretrain":
        cfg = C.tiny_pretrain_config() if args.tiny else C.geomae_pretrain_nus()
        state = PT.init_state(cfg, "cpu")
    else:
        cfg = C.tiny_finetune_config() if args.tiny else C.geomae_finetune_nus()
        state = FT.init_state(cfg, "cpu")
    state = CheckpointManager(args.ckpt_dir).restore(state)
    save_weights(args.out, state.model.state_dict())
    print(f"published weights-only checkpoint -> {args.out}")


def analyze_logs(args) -> None:
    """Mean iteration time and each loss's first, last and least value
    from a ``metrics.jsonl``."""
    with open(args.log) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if not rows:
        print("empty log")
        return
    keys = [k for k in rows[-1] if k.startswith("loss")]
    n = len(rows)
    it = sum(r.get("iter_time", 0) for r in rows) / n
    print(f"{n} log points, mean iter_time {it:.4f}s")
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        print(f"  {k}: first {vals[0]:.4f} last {vals[-1]:.4f} "
              f"min {min(vals):.4f}")


def browse_dataset(args) -> None:
    """A line per pretrain frame: its points, x and z extent and the
    largest sweep time lag."""
    from .data.nuscenes import NuScenesSSLDataset

    cfg = C.geomae_pretrain_nus()
    cfg = C.replace(cfg, data=C.replace(cfg.data, data_root=args.data_root,
                                        ann_file=args.ann_file))
    ds = NuScenesSSLDataset(cfg.data, cfg.voxel, cfg.caps)
    for i in range(min(args.n, len(ds))):
        s = ds.__getitem__(i, seed=0)
        pts = s["points"][s["point_valid"]]
        print(f"frame {i}: {len(pts)} pts, x[{pts[:,0].min():.1f},"
              f"{pts[:,0].max():.1f}] z[{pts[:,2].min():.1f},"
              f"{pts[:,2].max():.1f}] sweeps dt max {pts[:,4].max():.2f}s")


def visualize_results(args) -> None:
    """Serve ``-n`` random clouds over the point range and dump each
    frame's points and boxes as OBJ files (and a BEV PNG where matplotlib
    is installed)."""
    from .apis import Detector3D
    from .core.visualize import show_result

    cfg = C.tiny_finetune_config() if args.tiny else C.geomae_finetune_nus()
    det = Detector3D(cfg, args.ckpt_dir, device=args.device)
    rng = np.random.default_rng(0)
    r = cfg.voxel.point_cloud_range
    for i in range(args.n):
        P = cfg.caps.max_points
        pts = rng.uniform([r[0], r[1], r[2], 0, 0],
                          [r[3], r[4], r[5], 1, 0.4],
                          (P, 5)).astype(np.float32)
        out = det(pts)
        sel = out["scores"] >= args.score_thr
        written = show_result(pts[:, :3], None, out["boxes"][sel],
                              args.out_dir, f"frame{i:04d}",
                              scores=out["scores"][sel])
        print(f"frame{i:04d}: {int(sel.sum())} boxes -> "
              + ", ".join(written.values()))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m geomae_tpu_torch.misc_tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("print_config")
    pc.add_argument("config", choices=["pretrain", "finetune",
                                       "tiny_pretrain", "tiny_finetune"])
    pm = sub.add_parser("publish_model")
    pm.add_argument("--ckpt-dir", required=True)
    pm.add_argument("--out", required=True)
    pm.add_argument("--task", choices=["pretrain", "finetune"],
                    default="pretrain")
    pm.add_argument("--tiny", action="store_true")
    al = sub.add_parser("analyze_logs")
    al.add_argument("--log", required=True)
    bd = sub.add_parser("browse_dataset")
    bd.add_argument("--data-root", default="data/nuscenes")
    bd.add_argument("--ann-file", default="nuscenes_ssl_infos_train.pkl")
    bd.add_argument("-n", type=int, default=5)
    vr = sub.add_parser("visualize_results")
    vr.add_argument("--ckpt-dir", default=None)
    vr.add_argument("--out-dir", default="viz")
    vr.add_argument("--tiny", action="store_true")
    vr.add_argument("--score-thr", type=float, default=0.3)
    vr.add_argument("-n", type=int, default=2)
    vr.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    dict(print_config=print_config, publish_model=publish_model,
         analyze_logs=analyze_logs, browse_dataset=browse_dataset,
         visualize_results=visualize_results)[args.cmd](args)


if __name__ == "__main__":
    main()
