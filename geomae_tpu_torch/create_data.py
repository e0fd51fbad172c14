"""Dataset preparation entry point, the port's counterpart of the JAX
package's ``tools/create_data.py`` (the reference's
``tools/create_data.py``): the same tasks, arguments and defaults, and
the same pickles and GT database.

    python -m geomae_tpu_torch.create_data nuscenes --root-path data/nuscenes \\
        --out-dir data/nuscenes
    python -m geomae_tpu_torch.create_data nuscenes_ssl --root-path data/nuscenes \\
        --out-dir data/nuscenes
    python -m geomae_tpu_torch.create_data gt_database --root-path data/nuscenes \\
        --ann-file nuscenes_infos_train.pkl --out-dir data/nuscenes
    python -m geomae_tpu_torch.create_data waymo --root-path data/waymo \\
        --out-dir data/waymo --max-sweeps 5
    # infos only (KITTI-format tree already on disk; no Waymo devkit needed):
    python -m geomae_tpu_torch.create_data waymo_infos \\
        --root-path data/waymo/kitti_format
    python -m geomae_tpu_torch.create_data kitti --root-path data/kitti \\
        --out-dir data/kitti

``nuscenes`` and ``nuscenes_ssl`` need ``nuscenes-devkit``, ``lyft``
needs ``lyft_dataset_sdk`` and ``waymo`` the Waymo devkit and TensorFlow;
each raises ImportError without them.  ``waymo_infos``, ``kitti`` and
``gt_database`` are numpy only.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .data import converters, kitti_converter, waymo_converter

TASKS = ("nuscenes", "nuscenes_ssl", "gt_database", "waymo", "waymo_infos",
         "kitti", "lyft")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m geomae_tpu_torch.create_data")
    p.add_argument("task", choices=TASKS)
    p.add_argument("--root-path", default="data/nuscenes")
    p.add_argument("--out-dir", default="data/nuscenes")
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--max-sweeps", type=int, default=10)
    p.add_argument("--ann-file", default="nuscenes_infos_train.pkl")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.task in ("nuscenes", "nuscenes_ssl"):
        converters.create_nuscenes_infos(
            args.root_path, args.out_dir, version=args.version,
            max_sweeps=args.max_sweeps, ssl=args.task == "nuscenes_ssl")
    elif args.task == "waymo":
        # raw TFRecords -> KITTI format -> infos (Waymo devkit + TensorFlow)
        waymo_converter.convert_waymo_raw(args.root_path, args.out_dir,
                                          max_sweeps=args.max_sweeps)
    elif args.task == "waymo_infos":
        # KITTI-format tree -> info pkls, written beside the tree
        waymo_converter.create_waymo_info_file(args.root_path,
                                               max_sweeps=args.max_sweeps)
    elif args.task == "kitti":
        kitti_converter.create_kitti_info_file(args.root_path,
                                               save_path=args.out_dir)
    elif args.task == "lyft":
        converters.create_lyft_infos(args.root_path, args.out_dir,
                                     version=args.version,
                                     max_sweeps=args.max_sweeps)
    else:
        converters.create_groundtruth_database(
            args.root_path, args.ann_file, args.out_dir)


if __name__ == "__main__":
    main()
