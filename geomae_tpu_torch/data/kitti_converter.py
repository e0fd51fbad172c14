"""KITTI raw-data info converter (pure numpy + filesystem).

The port's copy of ``geomae_tpu/data/kitti_converter.py``.  It rebuilds
the reference's ``create_kitti_info_file`` (``tools/data_converter/
kitti_converter.py:86-148`` + ``kitti_data_utils.get_kitti_image_info:
142``): walk the standard KITTI tree
(``training/{velodyne,calib,label_2}``, 6-digit frame ids, ImageSets
split files) and emit ``kitti_infos_{train,val,trainval,test}.pkl`` in
the schema :class:`geomae_tpu_torch.data.waymo.KittiDataset` consumes
(``point_cloud.velodyne_path`` + camera-frame ``annos`` + ``calib``).

Deviation (documented): ``num_points_in_gt`` counts all lidar points in
each box without the reference's image-FOV crop
(``_calculate_num_points_in_gt(remove_outside=True)``) — the crop needs
the camera projection and only tightens the dbsampler's min-points
filter.
"""
from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

from .waymo_converter import _num_points_in_gt, parse_label


def parse_kitti_calib(text: str) -> Dict[str, np.ndarray]:
    """KITTI calib file: P0..P3, R0_rect, Tr_velo_to_cam, Tr_imu_to_velo
    (``kitti_data_utils.get_kitti_image_info:203-240`` semantics, 4x4
    extended matrices)."""
    vals = {}
    for ln in text.strip().splitlines():
        if ":" not in ln:
            continue
        key, rest = ln.split(":", 1)
        vals[key.strip()] = np.array([float(v) for v in rest.split()])
    out: Dict[str, np.ndarray] = {}
    for i in range(4):
        P = vals[f"P{i}"].reshape(3, 4)
        ext = np.eye(4)
        ext[:3, :] = P
        out[f"P{i}"] = ext
    rect = np.zeros((4, 4))
    rect[3, 3] = 1.0
    rect[:3, :3] = vals["R0_rect"].reshape(3, 3)
    out["R0_rect"] = rect
    for key in ("Tr_velo_to_cam", "Tr_imu_to_velo"):
        if key in vals:
            tr = np.eye(4)
            tr[:3, :] = vals[key].reshape(3, 4)
            out[key] = tr
    return out


def _ids(data_root: str, split: str, name: str) -> List[str]:
    iset = os.path.join(data_root, "ImageSets", f"{name}.txt")
    if os.path.exists(iset):
        with open(iset) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if name in ("train", "trainval"):
        bins = sorted(glob(os.path.join(data_root, split, "velodyne",
                                        "*.bin")))
        return [os.path.splitext(os.path.basename(b))[0] for b in bins]
    return []


def build_kitti_infos(data_root: str, frame_ids: Sequence[str],
                      split: str = "training",
                      label_info: bool = True) -> List[Dict]:
    infos = []
    for fid in frame_ids:
        rel_velo = os.path.join(split, "velodyne", f"{fid}.bin")
        with open(os.path.join(data_root, split, "calib",
                               f"{fid}.txt")) as f:
            calib = parse_kitti_calib(f.read())
        info = dict(
            image=dict(image_idx=int(fid),
                       image_path=os.path.join(split, "image_2",
                                               f"{fid}.png")),
            point_cloud=dict(num_features=4, velodyne_path=rel_velo),
            calib=calib,
        )
        if label_info:
            lbl = os.path.join(data_root, split, "label_2", f"{fid}.txt")
            if os.path.exists(lbl):
                with open(lbl) as f:
                    annos = parse_label(f.read())
                velo = os.path.join(data_root, rel_velo)
                if os.path.exists(velo):
                    pts = np.fromfile(velo, np.float32).reshape(-1, 4)
                    annos["num_points_in_gt"] = _num_points_in_gt(
                        pts, annos, calib)
                info["annos"] = annos
        infos.append(info)
    return infos


def create_kitti_info_file(data_root: str, pkl_prefix: str = "kitti",
                           save_path: Optional[str] = None) -> None:
    """Write ``{prefix}_infos_{train,val,trainval,test}.pkl``."""
    save_path = save_path or data_root
    os.makedirs(save_path, exist_ok=True)
    train_ids = _ids(data_root, "training", "train")
    val_ids = _ids(data_root, "training", "val")
    test_ids = _ids(data_root, "testing", "test")

    def _dump(infos, name):
        path = os.path.join(save_path, f"{pkl_prefix}_infos_{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        print(f"wrote {len(infos)} infos -> {path}")

    train = build_kitti_infos(data_root, train_ids, "training")
    val = build_kitti_infos(data_root, val_ids, "training")
    _dump(train, "train")
    _dump(val, "val")
    _dump(train + val, "trainval")
    if test_ids:
        _dump(build_kitti_infos(data_root, test_ids, "testing",
                                label_info=False), "test")
