"""Waymo dataset (KITTI-format infos), incl. the unlabeled-complement
variant used for multi-sweep pretraining, and KITTI.

The port's copy of ``geomae_tpu/data/waymo.py``: the data-loading half
of mmdet3d's ``WaymoDataset`` / ``WaymoDatasetComplement``
(``mmdet3d/datasets/waymo_dataset.py:140-320,688+``; info schema from
``tools/data_converter/waymo_converter.py``): 6-channel velodyne .bin
files (x y z intensity elongation ts), KITTI-style camera-frame annos
converted to LiDAR-frame boxes, multi-frame sweep merge via per-frame
ego poses (in float64).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..config import DataConfig, VoxelConfig
from . import transforms as T

WAYMO_CLASSES = ("Car", "Pedestrian", "Cyclist")


def load_waymo_infos(ann_file: str) -> List[Dict]:
    with open(ann_file, "rb") as f:
        infos = pickle.load(f)
    return infos if isinstance(infos, list) else infos.get("infos", [])


def _load_bin(path: str, dims: int = 6) -> np.ndarray:
    return np.fromfile(path, np.float32).reshape(-1, dims)


def _annos_to_lidar_boxes(annos: Dict, calib: Dict) -> np.ndarray:
    """KITTI camera-frame annos -> LiDAR [N, 7] (x y z_bottom w l h yaw)."""
    loc = np.asarray(annos["location"], np.float32).reshape(-1, 3)
    dims = np.asarray(annos["dimensions"], np.float32).reshape(-1, 3)  # lhw
    rots = np.asarray(annos["rotation_y"], np.float32).reshape(-1)
    if len(loc) == 0:
        return np.zeros((0, 7), np.float32)
    rect = np.asarray(calib["R0_rect"], np.float32).reshape(4, 4)
    tr = np.asarray(calib["Tr_velo_to_cam"], np.float32).reshape(4, 4)
    inv = np.linalg.inv(rect @ tr)
    hom = np.concatenate([loc, np.ones((len(loc), 1), np.float32)], 1)
    xyz = (hom @ inv.T)[:, :3]
    l, h, w = dims[:, 0], dims[:, 1], dims[:, 2]
    yaw = -rots - np.pi / 2
    return np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], l, w, h, yaw],
                    -1).astype(np.float32)


class WaymoDataset:
    """Detection dataset over KITTI-format waymo infos."""

    def __init__(self, cfg: DataConfig, voxel: VoxelConfig, caps,
                 max_gt_boxes: int = 512, test_mode: bool = False,
                 infos: Optional[List[Dict]] = None, load_dims: int = 6,
                 use_dims: int = 5):
        self.cfg, self.voxel, self.caps = cfg, voxel, caps
        self.max_gt = max_gt_boxes
        self.test_mode = test_mode
        self.load_dims, self.use_dims = load_dims, use_dims
        self.infos = infos if infos is not None else load_waymo_infos(
            os.path.join(cfg.data_root, cfg.ann_file))

    def __len__(self):
        return len(self.infos)

    def _points(self, info: Dict, rng) -> np.ndarray:
        path = info["point_cloud"]["velodyne_path"]
        if not os.path.isabs(path):
            path = os.path.join(self.cfg.data_root, path)
        pts = _load_bin(path, self.load_dims)[:, :self.use_dims].copy()
        pts[:, 4] = 0.0  # time channel of the key frame
        out = [pts]
        pose_inv = None
        for sw in info.get("sweeps", [])[: self.cfg.sweeps_num]:
            sp = sw["velodyne_path"]
            if not os.path.isabs(sp):
                sp = os.path.join(self.cfg.data_root, sp)
            if not os.path.exists(sp):
                continue
            s = _load_bin(sp, self.load_dims)[:, :self.use_dims].copy()
            if "pose" in sw and "pose" in info:
                if pose_inv is None:
                    pose_inv = np.linalg.inv(
                        np.asarray(info["pose"], np.float64))
                rel = pose_inv @ np.asarray(sw["pose"], np.float64)
                s[:, :3] = (s[:, :3] @ rel[:3, :3].T + rel[:3, 3]).astype(
                    np.float32)
            s[:, 4] = (info["timestamp"] - sw["timestamp"]) / 1e6 \
                if "timestamp" in sw else 0.1
            out.append(s)
        return np.concatenate(out).astype(np.float32)

    def get_ann(self, idx: int):
        info = self.infos[idx]
        annos = info.get("annos")
        if annos is None:
            return np.zeros((0, 9), np.float32), np.zeros((0,), np.int32)
        boxes = _annos_to_lidar_boxes(annos, info.get("calib", {}))
        names = np.asarray(annos["name"])
        labels = np.asarray([WAYMO_CLASSES.index(n) if n in WAYMO_CLASSES
                             else -1 for n in names], np.int32)
        keep = labels >= 0
        boxes = np.concatenate(
            [boxes, np.zeros((len(boxes), 2), np.float32)], -1)
        return boxes[keep], labels[keep]

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        rng = np.random.default_rng(
            seed if seed is not None else np.random.randint(0, 2**31))
        cfg = self.cfg
        pts = self._points(self.infos[idx], rng)
        if self.test_mode:
            sample = T.points_range_filter(dict(points=pts),
                                           self.voxel.point_cloud_range)
            p, v = T.pad_points(sample["points"], self.caps.max_points)
            return dict(points=p, point_valid=v)
        boxes, labels = self.get_ann(idx)
        sample = dict(points=pts, boxes=boxes, labels=labels)
        sample = T.global_rot_scale_trans(sample, rng, cfg.rot_range,
                                          cfg.scale_range, cfg.translation_std)
        sample = T.random_flip_3d(sample, rng, cfg.flip_ratio_horizontal,
                                  cfg.flip_ratio_vertical)
        sample = T.points_range_filter(sample, self.voxel.point_cloud_range)
        sample = T.object_range_filter(sample, self.voxel.point_cloud_range)
        if cfg.shuffle_points:
            sample = T.point_shuffle(sample, rng)
        p, v = T.pad_points(sample["points"], self.caps.max_points, rng)
        b, l, m = T.pad_boxes(sample["boxes"], sample["labels"], self.max_gt)
        return dict(points=p, point_valid=v, gt_boxes=b, gt_labels=l,
                    gt_mask=m)


class KittiDataset(WaymoDataset):
    """KITTI detection dataset: the reference's ``KittiDataset`` shares the
    info schema (``point_cloud.velodyne_path`` + camera-frame ``annos`` +
    ``calib``); 4-channel velodyne points, Car/Pedestrian/Cyclist labels."""

    def __init__(self, *args, **kw):
        kw.setdefault("load_dims", 4)
        kw.setdefault("use_dims", 4)
        super().__init__(*args, **kw)


class WaymoSSLDataset(WaymoDataset):
    """Unlabeled multi-sweep frames for pretraining
    (``WaymoDatasetComplement`` role, ``configs/_base_/datasets/
    waymo-3d-no-gt-v13.py``)."""

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        rng = np.random.default_rng(
            seed if seed is not None else np.random.randint(0, 2**31))
        cfg = self.cfg
        pts = self._points(self.infos[idx], rng)
        sample = dict(points=pts)
        if not self.test_mode:
            sample = T.global_rot_scale_trans(
                sample, rng, cfg.rot_range, cfg.scale_range,
                cfg.translation_std)
            sample = T.random_flip_3d(sample, rng, cfg.flip_ratio_horizontal,
                                      cfg.flip_ratio_vertical)
        sample = T.points_range_filter(sample, self.voxel.point_cloud_range)
        if not self.test_mode and cfg.shuffle_points:
            sample = T.point_shuffle(sample, rng)
        p, v = T.pad_points(sample["points"], self.caps.max_points, rng)
        return dict(points=p, point_valid=v)
