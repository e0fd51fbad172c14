"""nuScenes info converters (standard + SSL) and GT-database creation.

The port's copy of ``geomae_tpu/data/converters.py``.  It rebuilds the
reference's ``tools/data_converter/nuscenes_converter.py`` and
``nuscenes_ssl_converter.py``:
walk the nuScenes tables with the official devkit and emit info .pkl files
in the schema consumed by ``geomae_tpu_torch.data.nuscenes``.

The SSL converter's distinguishing behavior (reference
``nuscenes_ssl_converter.py:220-270``): besides every keyframe it emits one
info entry per *intermediate* (non-keyframe) lidar sweep by walking each
keyframe's ``prev`` chain — ~10x more pretrain frames — each with its own
<=10-sweep history and no annotations.

Requires the ``nuscenes-devkit`` pip package (same as the reference); all
functions raise a clear ImportError otherwise.  The downstream schema is
documented in :mod:`geomae_tpu_torch.data.nuscenes` and covered by synthetic
fixtures, so this module is exercised end-to-end only where the devkit +
raw data exist.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np


def _require_devkit():
    try:
        from nuscenes.nuscenes import NuScenes  # noqa: F401
        from nuscenes.utils import splits  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "nuscenes-devkit is required for dataset conversion "
            "(pip install nuscenes-devkit), matching the reference's "
            "requirements/runtime.txt") from e


def _quat_rot(q) -> np.ndarray:
    from pyquaternion import Quaternion
    return Quaternion(q).rotation_matrix


def _lidar_record(nusc, sd_token: str, ref_pose, ref_cs) -> Dict:
    """sensor2lidar transform of sweep ``sd_token`` into the reference
    keyframe lidar frame (reference ``nuscenes_converter.obtain_sensor2top``
    semantics)."""
    sd = nusc.get("sample_data", sd_token)
    pose = nusc.get("ego_pose", sd["ego_pose_token"])
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    R_s2e = _quat_rot(cs["rotation"])
    t_s2e = np.asarray(cs["translation"])
    R_e2g = _quat_rot(pose["rotation"])
    t_e2g = np.asarray(pose["translation"])
    R_g2e_ref = _quat_rot(ref_pose["rotation"]).T
    t_ref_e2g = np.asarray(ref_pose["translation"])
    R_e2s_ref = _quat_rot(ref_cs["rotation"]).T
    t_ref_s2e = np.asarray(ref_cs["translation"])

    R = R_e2s_ref @ R_g2e_ref @ R_e2g @ R_s2e
    t = R_e2s_ref @ (R_g2e_ref @ (R_e2g @ t_s2e + t_e2g - t_ref_e2g)
                     - t_ref_s2e)
    return dict(
        data_path=str(nusc.get_sample_data_path(sd_token)),
        sample_data_token=sd_token,
        sensor2lidar_rotation=R,
        sensor2lidar_translation=t,
        timestamp=sd["timestamp"],
    )


def _sweeps_for(nusc, sd_token: str, max_sweeps: int) -> List[Dict]:
    ref_sd = nusc.get("sample_data", sd_token)
    ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
    ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
    sweeps = []
    cur = ref_sd
    while len(sweeps) < max_sweeps and cur["prev"]:
        cur = nusc.get("sample_data", cur["prev"])
        sweeps.append(_lidar_record(nusc, cur["token"], ref_pose, ref_cs))
    return sweeps


def _annotations(nusc, sample) -> Dict:
    from nuscenes.utils.data_classes import Box
    boxes7, names, velocities, valid = [], [], [], []
    num_pts = []
    _, boxes, _ = nusc.get_sample_data(
        sample["data"]["LIDAR_TOP"])
    for b, ann_tok in zip(boxes, sample["anns"]):
        ann = nusc.get("sample_annotation", ann_tok)
        vel = nusc.box_velocity(ann_tok)[:2]
        # devkit Box: center (x, y, z gravity), wlh; yaw about +z
        yaw = b.orientation.yaw_pitch_roll[0]
        boxes7.append([b.center[0], b.center[1],
                       b.center[2] - b.wlh[2] / 2,     # bottom z
                       b.wlh[0], b.wlh[1], b.wlh[2], yaw])
        names.append(ann["category_name"])
        velocities.append(vel)
        num_pts.append(ann["num_lidar_pts"] + ann["num_radar_pts"])
        valid.append(ann["num_lidar_pts"] + ann["num_radar_pts"] > 0)
    from .nuscenes import NAME_MAPPING
    names = [NAME_MAPPING.get(n, n) for n in names]
    return dict(
        gt_boxes=np.asarray(boxes7, np.float32).reshape(-1, 7),
        gt_names=np.asarray(names),
        gt_velocity=np.nan_to_num(np.asarray(velocities, np.float32)
                                  .reshape(-1, 2)),
        num_lidar_pts=np.asarray(num_pts),
        valid_flag=np.asarray(valid, bool),
    )


def create_nuscenes_infos(root_path: str, out_dir: str,
                          version: str = "v1.0-trainval",
                          max_sweeps: int = 10, ssl: bool = False,
                          info_prefix: str = "nuscenes"):
    """Write {prefix}_infos_{train,val}.pkl (set ``ssl=True`` for the SSL
    variant with intermediate sweeps and no annotations)."""
    _require_devkit()
    from nuscenes.nuscenes import NuScenes
    from nuscenes.utils import splits

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    if "mini" in version:
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    elif "test" in version:
        train_scenes, val_scenes = splits.test, []
    else:
        train_scenes, val_scenes = splits.train, splits.val
    scene_name_to_token = {s["name"]: s["token"] for s in nusc.scene}
    train_tokens = {scene_name_to_token[n] for n in train_scenes
                    if n in scene_name_to_token}
    val_tokens = {scene_name_to_token[n] for n in val_scenes
                  if n in scene_name_to_token}

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        lidar_tok = sample["data"]["LIDAR_TOP"]
        bucket = train_infos if sample["scene_token"] in train_tokens else (
            val_infos if sample["scene_token"] in val_tokens else None)
        if bucket is None:
            continue
        info = dict(
            lidar_path=str(nusc.get_sample_data_path(lidar_tok)),
            token=sample["token"],
            timestamp=sample["timestamp"],
            sweeps=_sweeps_for(nusc, lidar_tok, max_sweeps),
        )
        if not ssl:
            info.update(_annotations(nusc, sample))
        bucket.append(info)

        if ssl and bucket is train_infos:
            # one extra info per intermediate sweep (prev chain)
            cur = nusc.get("sample_data", lidar_tok)
            while cur["prev"]:
                cur = nusc.get("sample_data", cur["prev"])
                if cur["is_key_frame"]:
                    break
                bucket.append(dict(
                    lidar_path=str(nusc.get_sample_data_path(cur["token"])),
                    token=cur["token"],
                    timestamp=cur["timestamp"],
                    sweeps=_sweeps_for(nusc, cur["token"], max_sweeps),
                ))

    os.makedirs(out_dir, exist_ok=True)
    suffix = "_ssl" if ssl else ""
    meta = dict(version=version)
    for split, infos in (("train", train_infos), ("val", val_infos)):
        path = os.path.join(out_dir,
                            f"{info_prefix}{suffix}_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=meta), f)
        print(f"wrote {len(infos)} infos -> {path}")


def create_lyft_infos(root_path: str, out_dir: str,
                      version: str = "v1.01-train", max_sweeps: int = 10,
                      info_prefix: str = "lyft"):
    """Lyft info pkls via the lyft SDK (reference
    ``tools/data_converter/lyft_converter.py:16-100``).  The SDK exposes
    the nuScenes table API, so the walk is shared with
    :func:`create_nuscenes_infos`'s helpers; splits come from
    ``{root_path}/{train,val,test}.txt`` scene-name lists like the
    reference (``lyft_converter.py:39-44``)."""
    try:
        from lyft_dataset_sdk.lyftdataset import LyftDataset as Lyft
    except ImportError as e:  # pragma: no cover - sdk not in this image
        raise ImportError(
            "lyft_dataset_sdk is required for Lyft conversion "
            "(pip install lyft_dataset_sdk), matching the reference's "
            "requirements") from e

    lyft = Lyft(data_path=os.path.join(root_path, version),
                json_path=os.path.join(root_path, version, version),
                verbose=True)

    def _scene_list(name):
        path = os.path.join(root_path, f"{name}.txt")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    if version.endswith("test"):
        train_scenes, val_scenes = _scene_list("test"), []
    else:
        train_scenes, val_scenes = _scene_list("train"), _scene_list("val")
        if not train_scenes:           # no split files: everything -> train
            train_scenes = [s["name"] for s in lyft.scene]
    name_to_tok = {s["name"]: s["token"] for s in lyft.scene}
    train_toks = {name_to_tok[n] for n in train_scenes if n in name_to_tok}
    val_toks = {name_to_tok[n] for n in val_scenes if n in name_to_tok}

    train_infos, val_infos = [], []
    for sample in lyft.sample:
        bucket = train_infos if sample["scene_token"] in train_toks else (
            val_infos if sample["scene_token"] in val_toks else None)
        if bucket is None:
            continue
        lidar_tok = sample["data"]["LIDAR_TOP"]
        info = dict(
            lidar_path=str(lyft.get_sample_data_path(lidar_tok)),
            token=sample["token"],
            timestamp=sample["timestamp"],
            sweeps=_sweeps_for(lyft, lidar_tok, max_sweeps),
        )
        if not version.endswith("test"):
            # lyft annotations carry no velocity / lidar-point counts
            boxes7, names = [], []
            _, boxes, _ = lyft.get_sample_data(lidar_tok)
            for b in boxes:
                yaw = b.orientation.yaw_pitch_roll[0]
                boxes7.append([b.center[0], b.center[1],
                               b.center[2] - b.wlh[2] / 2,
                               b.wlh[0], b.wlh[1], b.wlh[2], yaw])
                names.append(b.name)
            info.update(
                gt_boxes=np.asarray(boxes7, np.float32).reshape(-1, 7),
                gt_names=np.asarray(names),
                gt_velocity=np.zeros((len(names), 2), np.float32),
                num_lidar_pts=np.ones(len(names), np.int64),
                valid_flag=np.ones(len(names), bool),
            )
        bucket.append(info)

    os.makedirs(out_dir, exist_ok=True)
    meta = dict(version=version)
    for split, infos in (("train", train_infos), ("val", val_infos)):
        path = os.path.join(out_dir, f"{info_prefix}_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=meta), f)
        print(f"wrote {len(infos)} infos -> {path}")


def create_groundtruth_database(data_root: str, ann_file: str, out_dir: str,
                                classes=None):
    """GT-database for ObjectSample paste augmentation (reference
    ``tools/data_converter/create_gt_database.py``): crop each annotated
    box's points into its local frame and save per-class .bin files + a
    dbinfos pkl."""
    from .nuscenes import NUS_CLASSES, NuScenesDetDataset, load_infos
    from .pointcloud import merge_sweeps

    classes = classes or NUS_CLASSES
    infos = load_infos(os.path.join(data_root, ann_file))
    db_dir = os.path.join(out_dir, "gt_database")
    os.makedirs(db_dir, exist_ok=True)
    db_infos: Dict[str, List[Dict]] = {c: [] for c in classes}

    for i, info in enumerate(infos):
        pts = merge_sweeps(info, data_root, sweeps_num=9)
        boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)
        names = np.asarray(info["gt_names"])
        for j, (b, name) in enumerate(zip(boxes, names)):
            if name not in db_infos:
                continue
            # points in rotated box (numpy; bottom-z convention)
            d = pts[:, :3] - np.array([b[0], b[1], b[2]])
            c, s = np.cos(-b[6]), np.sin(-b[6])
            lx = d[:, 0] * c - d[:, 1] * s
            ly = d[:, 0] * s + d[:, 1] * c
            m = ((np.abs(lx) <= b[3] / 2) & (np.abs(ly) <= b[4] / 2)
                 & (d[:, 2] >= 0) & (d[:, 2] <= b[5]))
            local = pts[m].copy()
            local[:, :3] -= [b[0], b[1], b[2]]
            fname = f"{i}_{name}_{j}.bin"
            local.astype(np.float32).tofile(os.path.join(db_dir, fname))
            db_infos[name].append(dict(
                name=name, path=os.path.join("gt_database", fname),
                gt_idx=j, box3d_lidar=b, num_points_in_gt=int(m.sum())))
    with open(os.path.join(out_dir, "nuscenes_dbinfos_train.pkl"), "wb") as f:
        pickle.dump(db_infos, f)
    print({k: len(v) for k, v in db_infos.items()})
