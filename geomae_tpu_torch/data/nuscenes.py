"""nuScenes datasets (SSL pretrain + detection fine-tune).

The port's copy of ``geomae_tpu/data/nuscenes.py``: host-side rebuilds
of mmdet3d's ``NuScenesDatasetSSL``
(``mmdet3d/datasets/nuscenes_ssl_dataset.py:16``) and
``NuScenesDataset`` (``nuscenes_dataset.py``).  They read the info .pkl
produced by the converters, run the pipeline (multi-sweep merge ->
rot/scale/trans -> flips -> range filter -> shuffle), and emit
fixed-shape padded numpy arrays ready for the device.  ``CBGSDataset``
class-balanced resampling (``dataset_wrappers.py:7-75``) is a pure index
expansion.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import DataConfig, VoxelConfig
from . import transforms as T
from .native_prep import build_scene_host, prepare_ssl_sample
from .pointcloud import merge_sweeps

NUS_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")

# NameMapping from the nuScenes devkit (general category -> class name),
# as used by the reference converter (tools/data_converter/nuscenes_converter.py)
NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def load_infos(ann_file: str) -> List[Dict]:
    with open(ann_file, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data
    return sorted(infos, key=lambda e: e["timestamp"])


class NuScenesSSLDataset:
    """Unlabeled multi-sweep frames for GeoMAE pretraining.

    ``native=True`` (the default) runs the whole merge + augment + filter
    + pad pipeline as fused C++ per sweep (``data/native_prep.py``) and
    raises if the library cannot be built; ``native=False`` runs the
    numpy pipeline below (same semantics).  ``precompute_scene`` sorts
    the scene on the host too (native only), so the step skips the
    device sort (``train/pretrain.targets_and_mask``)."""

    def __init__(self, cfg: DataConfig, voxel: VoxelConfig, caps,
                 test_mode: bool = False, infos: Optional[List[Dict]] = None,
                 native: bool = True, precompute_scene: bool = False):
        if precompute_scene and not native:
            raise ValueError("precompute_scene needs the native pipeline")
        self.cfg = cfg
        self.voxel = voxel
        self.caps = caps
        self.test_mode = test_mode
        self.native = native
        self.precompute_scene = precompute_scene
        self.infos = infos if infos is not None else load_infos(
            f"{cfg.data_root}/{cfg.ann_file}")

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        rng = np.random.default_rng(
            seed if seed is not None else np.random.randint(0, 2**31))
        cfg = self.cfg
        if self.native:
            out = prepare_ssl_sample(self.infos[idx], cfg, self.voxel,
                                     self.caps, rng,
                                     train=not self.test_mode)
            if self.precompute_scene:
                return build_scene_host(
                    out["points"], int(out["point_valid"].sum()),
                    self.voxel, self.caps.max_voxels)
            return out
        pts = merge_sweeps(self.infos[idx], cfg.data_root, cfg.sweeps_num,
                           cfg.load_dim, cfg.use_dim,
                           cfg.remove_close_radius, test_mode=self.test_mode,
                           rng=rng)
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
        points, valid = T.pad_points(sample["points"], self.caps.max_points,
                                     rng)
        return dict(points=points, point_valid=valid)


class NuScenesDetDataset:
    """Labeled key frames for detection fine-tune."""

    CLASSES = NUS_CLASSES

    def __init__(self, cfg: DataConfig, voxel: VoxelConfig, caps,
                 max_gt_boxes: int = 512, test_mode: bool = False,
                 infos: Optional[List[Dict]] = None,
                 use_valid_flag: bool = True,
                 db_sampler=None):
        self.cfg = cfg
        self.voxel = voxel
        self.caps = caps
        self.max_gt = max_gt_boxes
        self.test_mode = test_mode
        self.use_valid_flag = use_valid_flag
        self.db_sampler = db_sampler
        self.infos = infos if infos is not None else load_infos(
            f"{cfg.data_root}/{cfg.ann_file}")

    def __len__(self):
        return len(self.infos)

    def get_ann(self, idx: int):
        info = self.infos[idx]
        boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)
        names = np.asarray(info["gt_names"])
        if "gt_velocity" in info and len(boxes):
            vel = np.nan_to_num(np.asarray(info["gt_velocity"], np.float32))
            boxes = np.concatenate([boxes, vel.reshape(-1, 2)], -1)
        elif len(boxes):
            boxes = np.concatenate(
                [boxes, np.zeros((len(boxes), 2), np.float32)], -1)
        if self.use_valid_flag and "valid_flag" in info:
            m = np.asarray(info["valid_flag"], bool)
            boxes, names = boxes[m], names[m]
        cls = self.CLASSES
        labels = np.array(
            [cls.index(n) if n in cls else -1 for n in names], np.int32)
        keep = labels >= 0
        return boxes[keep], labels[keep]

    def cat_ids(self, idx: int) -> Sequence[int]:
        _, labels = self.get_ann(idx)
        return sorted(set(labels.tolist()))

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        rng = np.random.default_rng(
            seed if seed is not None else np.random.randint(0, 2**31))
        cfg = self.cfg
        pts = merge_sweeps(self.infos[idx], cfg.data_root, cfg.sweeps_num,
                           cfg.load_dim, cfg.use_dim,
                           cfg.remove_close_radius, test_mode=self.test_mode,
                           rng=rng)
        if self.test_mode:
            sample = dict(points=pts)
            sample = T.points_range_filter(sample,
                                           self.voxel.point_cloud_range)
            points, valid = T.pad_points(sample["points"],
                                         self.caps.max_points)
            return dict(points=points, point_valid=valid)

        boxes, labels = self.get_ann(idx)
        sample = dict(points=pts, boxes=boxes, labels=labels)
        if self.db_sampler is not None:
            sample = self.db_sampler(sample, rng)
        sample = T.global_rot_scale_trans(sample, rng, cfg.rot_range,
                                          cfg.scale_range,
                                          cfg.translation_std)
        sample = T.random_flip_3d(sample, rng, cfg.flip_ratio_horizontal,
                                  cfg.flip_ratio_vertical)
        sample = T.points_range_filter(sample, self.voxel.point_cloud_range)
        sample = T.object_range_filter(sample, self.voxel.point_cloud_range)
        if cfg.shuffle_points:
            sample = T.point_shuffle(sample, rng)
        points, valid = T.pad_points(sample["points"], self.caps.max_points,
                                     rng)
        gt_boxes, gt_labels, gt_mask = T.pad_boxes(
            sample["boxes"], sample["labels"], self.max_gt)
        return dict(points=points, point_valid=valid, gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_mask=gt_mask)


class CBGSDataset:
    """Class-balanced grouping & sampling wrapper
    (reference ``dataset_wrappers.py:7-75``): duplicate sample indices so
    every class appears with frequency ~1/num_classes."""

    def __init__(self, dataset: NuScenesDetDataset):
        self.dataset = dataset
        self.indices = self._balanced_indices()

    def _balanced_indices(self) -> List[int]:
        n_cls = len(self.dataset.CLASSES)
        cls_to_samples: Dict[int, List[int]] = {c: [] for c in range(n_cls)}
        for i in range(len(self.dataset)):
            for c in self.dataset.cat_ids(i):
                cls_to_samples[c].append(i)
        duplicated = sum(len(v) for v in cls_to_samples.values())
        frac = 1.0 / n_cls
        out: List[int] = []
        rng = np.random.default_rng(0)
        for c, samples in cls_to_samples.items():
            if not samples:
                continue
            ratio = frac / (len(samples) / max(duplicated, 1))
            take = int(len(samples) * ratio)
            out.extend(rng.choice(samples, take, replace=True).tolist())
        return out

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int, seed=None):
        return self.dataset.__getitem__(self.indices[idx], seed=seed)


LYFT_CLASSES = ("car", "truck", "bus", "emergency_vehicle", "other_vehicle",
                "motorcycle", "bicycle", "pedestrian", "animal")


class LyftDataset(NuScenesDetDataset):
    """Level-5 (Lyft) detection frames (mmdet3d's
    ``datasets/lyft_dataset.py``; inherited, off the GeoMAE path): the
    nuScenes info schema minus velocity annotations — the reader pads the
    two velocity dims with zeros — with the Lyft class vocabulary."""

    CLASSES = LYFT_CLASSES
