"""Waymo raw-data converter: TFRecords -> KITTI-format dirs -> info pkls.

The port's copy of ``geomae_tpu/data/waymo_converter.py``, the same numpy
functions, writing the same pickles.  It rebuilds the reference's
two-stage Waymo preparation (``tools/data_converter/waymo_converter.py`` +
``kitti_converter.create_waymo_info_file:149`` +
``kitti_data_utils.get_waymo_image_info:266``):

1. :class:`WaymoRawConverter` — parse each TFRecord frame with the official
   ``waymo_open_dataset`` devkit and write KITTI-format artifacts:
   ``velodyne/*.bin`` (x y z intensity elongation timestamp, f32),
   ``calib/*.txt``, ``label_all/*.txt`` (camera-frame boxes) and
   ``pose/*.txt`` (4x4 vehicle->global).  Devkit-gated exactly like the
   reference (it requires ``waymo-open-dataset`` + tensorflow).
2. :func:`create_waymo_info_file` — pure numpy + filesystem: walk the
   KITTI-format tree and emit ``waymo_infos_{train,val,trainval,test}.pkl``
   in the schema :class:`geomae_tpu_torch.data.waymo.WaymoDataset`
   consumes, including the per-frame pose chain for multi-sweep merging
   (``kitti_data_utils.py:409-438``).  No devkit needed — testable with
   synthetic fixtures.
3. :func:`complement_infos` — the ``WaymoDatasetComplement`` selection
   (``mmdet3d/datasets/waymo_dataset.py:756-763``): keep the frames NOT
   sampled by ``[::load_interval]``, i.e. pretrain on the unlabeled
   complement of the fine-tune subset.

The pure transform pieces (label projection, calib formatting) are
standalone numpy helpers so the pose/label math is covered by fixture
tests without the devkit.
"""
from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

# waymo front camera -> KITTI reference camera axes
# (waymo_converter.py:150-152): x-y-z front-left-up -> right-down-front
T_FRONT_CAM_TO_REF = np.array([[0.0, -1.0, 0.0],
                               [0.0, 0.0, -1.0],
                               [1.0, 0.0, 0.0]])

WAYMO_TYPE_TO_KITTI = {
    "UNKNOWN": "DontCare", "PEDESTRIAN": "Pedestrian", "VEHICLE": "Car",
    "CYCLIST": "Cyclist", "SIGN": "Sign",
}
SELECTED_WAYMO_CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")


def cart_to_homo(mat: np.ndarray) -> np.ndarray:
    """3x3 or 3x4 -> homogeneous 4x4 (``waymo_converter.py:499-515``)."""
    ret = np.eye(4)
    if mat.shape == (3, 3):
        ret[:3, :3] = mat
    elif mat.shape == (3, 4):
        ret[:3, :] = mat
    else:
        raise ValueError(mat.shape)
    return ret


def velo_to_front_cam(front_cam_extrinsic: np.ndarray) -> np.ndarray:
    """T_velo_to_front_cam from the front camera's cam->vehicle extrinsic
    (``waymo_converter.py:160-166``)."""
    return cart_to_homo(T_FRONT_CAM_TO_REF) @ np.linalg.inv(
        front_cam_extrinsic)


def waymo_label_to_kitti_line(kitti_type: str, box7_vehicle: Sequence[float],
                              T_velo_to_cam: np.ndarray,
                              bbox2d=(0.0, 0.0, 0.0, 0.0),
                              camera_id: str = "0") -> str:
    """One KITTI ``label_all`` line from a waymo laser label.

    ``box7_vehicle`` = (cx, cy, cz_CENTER, length, width, height, heading)
    in the vehicle frame.  Matches ``waymo_converter.save_label:249-346``:
    z shifts center->bottom BEFORE the camera projection, dims are written
    h w l, ``rotation_y = -heading - pi/2``, and the 16th field is the
    camera id."""
    cx, cy, cz, length, width, height, heading = box7_vehicle
    z_bottom = cz - height / 2
    pt = T_velo_to_cam @ np.array([cx, cy, z_bottom, 1.0])
    x, y, z = pt[:3]
    rotation_y = -heading - np.pi / 2
    line = (f"{kitti_type} 0 0 -10 "
            f"{round(bbox2d[0], 2)} {round(bbox2d[1], 2)} "
            f"{round(bbox2d[2], 2)} {round(bbox2d[3], 2)} "
            f"{round(height, 2)} {round(width, 2)} {round(length, 2)} "
            f"{round(x, 2)} {round(y, 2)} {round(z, 2)} "
            f"{round(rotation_y, 2)}")
    return f"{line} {camera_id}"


def format_calib(camera_calibs: List[np.ndarray],
                 Tr_velo_to_cams: List[np.ndarray]) -> str:
    """KITTI calib text (``waymo_converter.save_calib:142-197``): P0..P4
    (3x4 intrinsics), R0_rect (3x3 identity), Tr_velo_to_cam_0..4 (3x4)."""
    lines = []
    for i, P in enumerate(camera_calibs):
        vals = " ".join(f"{v:e}" for v in np.asarray(P).reshape(12))
        lines.append(f"P{i}: {vals}")
    rect = " ".join(f"{v:e}" for v in np.eye(3).reshape(9))
    lines.append(f"R0_rect: {rect}")
    for i, T in enumerate(Tr_velo_to_cams):
        vals = " ".join(f"{v:e}" for v in np.asarray(T)[:3, :].reshape(12))
        lines.append(f"Tr_velo_to_cam_{i}: {vals}")
    return "\n".join(lines) + "\n"


def parse_calib(text: str) -> Dict[str, np.ndarray]:
    """Calib dict with extended 4x4 matrices
    (``kitti_data_utils.get_waymo_image_info:352-390``): P0..P4, R0_rect,
    Tr_velo_to_cam (= camera 0's)."""
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    def _vals(ln, n):
        return np.array([float(v) for v in ln.split(" ")[1:n + 1]])
    out: Dict[str, np.ndarray] = {}
    for i in range(5):
        P = _vals(lines[i], 12).reshape(3, 4)
        ext = np.eye(4)
        ext[:3, :] = P
        out[f"P{i}"] = ext
    rect = np.zeros((4, 4))
    rect[3, 3] = 1.0
    rect[:3, :3] = _vals(lines[5], 9).reshape(3, 3)
    out["R0_rect"] = rect
    tr = np.eye(4)
    tr[:3, :] = _vals(lines[6], 12).reshape(3, 4)
    out["Tr_velo_to_cam"] = tr
    return out


def parse_label(text: str) -> Dict[str, np.ndarray]:
    """``get_label_anno`` equivalent (``kitti_data_utils.py:93-135``):
    dims reorder hwl->lhw, ``camera_id`` from the 16th field."""
    content = [ln.strip().split(" ") for ln in text.splitlines()
               if ln.strip()]
    n = len(content)
    annos = dict(
        name=np.array([x[0] for x in content]),
        truncated=np.array([float(x[1]) for x in content]),
        occluded=np.array([int(float(x[2])) for x in content]),
        alpha=np.array([float(x[3]) for x in content]),
        bbox=np.array([[float(v) for v in x[4:8]]
                       for x in content]).reshape(-1, 4),
        dimensions=np.array([[float(v) for v in x[8:11]]
                             for x in content]).reshape(-1, 3)[:, [2, 0, 1]],
        location=np.array([[float(v) for v in x[11:14]]
                           for x in content]).reshape(-1, 3),
        rotation_y=np.array([float(x[14]) for x in content]).reshape(-1),
    )
    if n and len(content[0]) >= 16:
        annos["camera_id"] = np.array([float(x[15]) for x in content])
    else:
        annos["camera_id"] = np.zeros((n,))
    num_objects = len([x[0] for x in content if x[0] != "DontCare"])
    annos["index"] = np.array(
        list(range(num_objects)) + [-1] * (n - num_objects), np.int32)
    annos["group_ids"] = np.arange(n, dtype=np.int32)
    annos["difficulty"] = np.zeros((n,), np.int32)
    return annos


def _num_points_in_gt(points: np.ndarray, annos: Dict,
                      calib: Dict) -> np.ndarray:
    """``_calculate_num_points_in_gt`` (``kitti_converter.py:27-60``,
    remove_outside=False): count lidar points inside each camera-frame
    box after mapping it back to the lidar frame."""
    from .waymo import _annos_to_lidar_boxes
    boxes = _annos_to_lidar_boxes(annos, calib)          # [N, 7] bottom-z
    counts = np.zeros(len(boxes), np.int64)
    for j, b in enumerate(boxes):
        d = points[:, :3] - b[:3]
        c, s = np.cos(-b[6]), np.sin(-b[6])
        lx = d[:, 0] * c - d[:, 1] * s
        ly = d[:, 0] * s + d[:, 1] * c
        counts[j] = int(np.sum((np.abs(lx) <= b[3] / 2)
                               & (np.abs(ly) <= b[4] / 2)
                               & (d[:, 2] >= 0) & (d[:, 2] <= b[5])))
    return counts


def _frame_ids(split_dir: str, data_root: str,
               imageset: Optional[str]) -> List[str]:
    if imageset and os.path.exists(imageset):
        with open(imageset) as f:
            return [ln.strip() for ln in f if ln.strip()]
    bins = sorted(glob(os.path.join(split_dir, "velodyne", "*.bin")))
    return [os.path.splitext(os.path.basename(b))[0] for b in bins]


def build_waymo_infos(data_root: str, frame_ids: Sequence[str],
                      split: str = "training", max_sweeps: int = 5,
                      label_info: bool = True,
                      with_num_points: bool = True) -> List[Dict]:
    """Info dicts for the given 7-digit frame ids (pure numpy + fs).

    Schema matches ``get_waymo_image_info`` (``kitti_data_utils.py:
    266-445``): ``point_cloud.velodyne_path`` (relative), ``calib``,
    ``pose`` (4x4), ``timestamp`` (micros, read from the bin's last
    channel), ``annos`` and the ``sweeps`` prev-id walk, each sweep with
    its own pose + timestamp — exactly what ``WaymoDataset._points``
    consumes for ego-compensated multi-sweep merge."""
    split_dir = os.path.join(data_root, split)
    infos = []
    for fid in frame_ids:
        rel_velo = os.path.join(split, "velodyne", f"{fid}.bin")
        velo = os.path.join(data_root, rel_velo)
        points = np.fromfile(velo, np.float32).reshape(-1, 6)
        with open(os.path.join(split_dir, "calib", f"{fid}.txt")) as f:
            calib = parse_calib(f.read())
        pose = np.loadtxt(os.path.join(split_dir, "pose", f"{fid}.txt"))
        info = dict(
            image=dict(image_idx=int(fid),
                       image_shape=np.array([1, 1], np.int32)),
            point_cloud=dict(num_features=6, velodyne_path=rel_velo),
            calib=calib,
            pose=pose,
            timestamp=np.int64(points[0, -1]) if len(points) else np.int64(0),
        )
        if label_info:
            lbl = os.path.join(split_dir, "label_all", f"{fid}.txt")
            if os.path.exists(lbl):
                with open(lbl) as f:
                    annos = parse_label(f.read())
                if with_num_points:
                    annos["num_points_in_gt"] = _num_points_in_gt(
                        points, annos, calib)
                info["annos"] = annos
        # sweep walk: consecutive previous frame ids within the same
        # segment (same prefix+file_idx; frame_idx is the last 3 digits)
        sweeps = []
        prev = int(fid)
        while len(sweeps) < max_sweeps:
            prev -= 1
            if prev < 0 or prev // 1000 != int(fid) // 1000:
                break
            pf = f"{prev:0{len(fid)}d}"
            rel = os.path.join(split, "velodyne", f"{pf}.bin")
            pv = os.path.join(data_root, rel)
            if not os.path.exists(pv):
                break
            ppts = np.fromfile(pv, np.float32).reshape(-1, 6)
            sweeps.append(dict(
                velodyne_path=rel,
                timestamp=np.int64(ppts[0, -1]) if len(ppts)
                else np.int64(0),
                pose=np.loadtxt(
                    os.path.join(split_dir, "pose", f"{pf}.txt")),
            ))
        info["sweeps"] = sweeps
        infos.append(info)
    return infos


def create_waymo_info_file(data_root: str, pkl_prefix: str = "waymo",
                           save_path: Optional[str] = None,
                           max_sweeps: int = 5) -> None:
    """Write ``{prefix}_infos_{train,val,trainval,test}.pkl``
    (``kitti_converter.create_waymo_info_file:149-227``).  Splits come
    from ``ImageSets/{train,val,test}.txt`` when present; otherwise train
    = every frame under ``training/velodyne`` with prefix 0, val = prefix
    1, test = everything under ``testing/velodyne``."""
    save_path = save_path or data_root
    os.makedirs(save_path, exist_ok=True)
    iset = os.path.join(data_root, "ImageSets")

    train_ids = _frame_ids(os.path.join(data_root, "training"), data_root,
                           os.path.join(iset, "train.txt"))
    val_ids = _frame_ids(os.path.join(data_root, "training"), data_root,
                         os.path.join(iset, "val.txt"))
    if not os.path.exists(os.path.join(iset, "train.txt")):
        all_ids = train_ids
        train_ids = [i for i in all_ids if not i.startswith("1")]
        val_ids = [i for i in all_ids if i.startswith("1")]
    test_ids = _frame_ids(os.path.join(data_root, "testing"), data_root,
                          os.path.join(iset, "test.txt"))

    def _dump(infos, name):
        path = os.path.join(save_path, f"{pkl_prefix}_infos_{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        print(f"wrote {len(infos)} infos -> {path}")

    train = build_waymo_infos(data_root, train_ids, "training", max_sweeps)
    val = build_waymo_infos(data_root, val_ids, "training", max_sweeps)
    _dump(train, "train")
    _dump(val, "val")
    _dump(train + val, "trainval")
    if test_ids:
        _dump(build_waymo_infos(data_root, test_ids, "testing", max_sweeps,
                                label_info=False), "test")


def complement_infos(infos: List[Dict], load_interval: int) -> List[Dict]:
    """The ``WaymoDatasetComplement`` frame selection
    (``waymo_dataset.py:756-763``): drop every ``load_interval``-th frame
    (the fine-tune subset) and keep the rest for unlabeled pretraining."""
    flag = np.ones(len(infos), bool)
    flag[::load_interval] = False
    return [info for info, keep in zip(infos, flag) if keep]


# ---------------------------------------------------------------------------
# TFRecord extraction (devkit-gated, like the reference)
# ---------------------------------------------------------------------------


def _require_waymo_devkit():
    try:
        import tensorflow  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        from waymo_open_dataset.utils import frame_utils  # noqa: F401
    except ImportError as e:  # pragma: no cover - devkit not in this image
        raise ImportError(
            "waymo-open-dataset + tensorflow are required for raw TFRecord "
            "conversion (pip install waymo-open-dataset-tf-2-x), matching "
            "the reference's waymo_converter.py") from e


class WaymoRawConverter:
    """TFRecords -> KITTI-format artifacts (``Waymo2KITTI`` role).

    Writes, per frame id ``{prefix}{file_idx:03d}{frame_idx:03d}``:
    ``velodyne/<id>.bin`` (both lidar returns, all 5 lasers, channels
    x y z intensity elongation timestamp_micros), ``calib/<id>.txt``,
    ``pose/<id>.txt`` and (unless ``test_mode``) ``label_all/<id>.txt``.
    Frames outside ``selected_locations`` (when set) are skipped, labels
    with zero lidar points are dropped (``filter_empty_3dboxes``), and
    no-label-zone points are removed — the reference's defaults.
    """

    def __init__(self, load_dir: str, save_dir: str, prefix: str,
                 test_mode: bool = False,
                 selected_locations: Optional[Sequence[str]] = None):
        _require_waymo_devkit()
        self.load_dir, self.save_dir = load_dir, save_dir
        self.prefix, self.test_mode = str(prefix), test_mode
        self.selected_locations = selected_locations
        self.pathnames = sorted(glob(os.path.join(load_dir, "*.tfrecord")))
        for sub in ("velodyne", "calib", "pose") + (
                () if test_mode else ("label_all",)):
            os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    def convert(self):  # pragma: no cover - needs devkit + raw data
        for file_idx in range(len(self.pathnames)):
            self.convert_one(file_idx)

    def convert_one(self, file_idx: int):  # pragma: no cover - devkit
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2

        ds = tf.data.TFRecordDataset(self.pathnames[file_idx],
                                     compression_type="")
        for frame_idx, data in enumerate(ds):
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(data.numpy()))
            if (self.selected_locations is not None and
                    frame.context.stats.location
                    not in self.selected_locations):
                continue
            fid = f"{self.prefix}{file_idx:03d}{frame_idx:03d}"
            self._save_lidar(frame, fid)
            self._save_calib(frame, fid)
            self._save_pose(frame, fid)
            if not self.test_mode:
                self._save_label(frame, fid)

    def _save_lidar(self, frame, fid):  # pragma: no cover - devkit
        from waymo_open_dataset.utils import frame_utils
        parsed = frame_utils.parse_range_image_and_camera_projection(frame)
        range_images, camera_projections, _, top_pose = (
            parsed if len(parsed) == 4 else
            (parsed[0], parsed[1], None, parsed[2]))
        chunks = []
        for ri in (0, 1):   # both returns (waymo_converter.py:211-235)
            pts = frame_utils.convert_range_image_to_point_cloud(
                frame, range_images, camera_projections, top_pose,
                ri_index=ri, keep_polar_features=True)[0]
            # keep_polar_features rows: (range, intensity, elongation,
            # x, y, z)
            for p in pts:
                chunks.append(np.column_stack(
                    [p[:, 3:6], p[:, 1:2], p[:, 2:3]]))
        pc = np.concatenate(chunks, axis=0)
        ts = frame.timestamp_micros * np.ones((len(pc), 1), np.float32)
        out = np.column_stack([pc, ts]).astype(np.float32)
        out.tofile(os.path.join(self.save_dir, "velodyne", f"{fid}.bin"))

    def _save_calib(self, frame, fid):  # pragma: no cover - devkit
        camera_calibs, trs = [], []
        self._T_velo_to_front_cam = None
        for camera in sorted(frame.context.camera_calibrations,
                             key=lambda c: c.name):
            T_cam_to_vehicle = np.array(
                camera.extrinsic.transform).reshape(4, 4)
            T = velo_to_front_cam(T_cam_to_vehicle)
            if camera.name == 1:       # FRONT
                self._T_velo_to_front_cam = T.copy()
            trs.append(T)
            P = np.zeros((3, 4))
            P[0, 0], P[1, 1] = camera.intrinsic[0], camera.intrinsic[1]
            P[0, 2], P[1, 2] = camera.intrinsic[2], camera.intrinsic[3]
            P[2, 2] = 1.0
            camera_calibs.append(P)
        with open(os.path.join(self.save_dir, "calib", f"{fid}.txt"),
                  "w") as f:
            f.write(format_calib(camera_calibs, trs))

    def _save_pose(self, frame, fid):  # pragma: no cover - devkit
        pose = np.array(frame.pose.transform).reshape(4, 4)
        np.savetxt(os.path.join(self.save_dir, "pose", f"{fid}.txt"), pose)

    def _save_label(self, frame, fid):  # pragma: no cover - devkit
        type_list = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")
        id_to_bbox, id_to_name = {}, {}
        for labels in frame.projected_lidar_labels:
            for label in labels.labels:
                id_to_bbox[label.id] = (
                    label.box.center_x - label.box.length / 2,
                    label.box.center_y - label.box.width / 2,
                    label.box.center_x + label.box.length / 2,
                    label.box.center_y + label.box.width / 2)
                id_to_name[label.id] = labels.name - 1
        lines = []
        for obj in frame.laser_labels:
            bbox, cam = (0.0, 0.0, 0.0, 0.0), "0"
            for suffix in ("_FRONT", "_FRONT_RIGHT", "_FRONT_LEFT",
                           "_SIDE_RIGHT", "_SIDE_LEFT"):
                if obj.id + suffix in id_to_bbox:
                    bbox = id_to_bbox[obj.id + suffix]
                    cam = str(id_to_name[obj.id + suffix])
                    break
            wtype = type_list[obj.type]
            if wtype not in SELECTED_WAYMO_CLASSES:
                continue
            if obj.num_lidar_points_in_box < 1:   # filter_empty_3dboxes
                continue
            lines.append(waymo_label_to_kitti_line(
                WAYMO_TYPE_TO_KITTI[wtype],
                (obj.box.center_x, obj.box.center_y, obj.box.center_z,
                 obj.box.length, obj.box.width, obj.box.height,
                 obj.box.heading),
                self._T_velo_to_front_cam, bbox, cam))
        with open(os.path.join(self.save_dir, "label_all", f"{fid}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))


def convert_waymo_raw(root_path: str, out_dir: str,
                      max_sweeps: int = 5) -> None:
    """Full pipeline (``create_data.waymo_data_prep:194-233``): raw
    ``waymo_format/{training,validation,testing}`` TFRecords -> KITTI
    format under ``out_dir/kitti_format`` -> info pkls.  Validation
    frames land in ``training/`` with prefix 1, like the reference."""
    kitti_dir = os.path.join(out_dir, "kitti_format")
    for i, split in enumerate(("training", "validation", "testing")):
        load_dir = os.path.join(root_path, "waymo_format", split)
        if not os.path.isdir(load_dir):
            continue
        save_split = "training" if split != "testing" else "testing"
        WaymoRawConverter(load_dir, os.path.join(kitti_dir, save_split),
                          prefix=str(i),
                          test_mode=(split == "testing")).convert()
    create_waymo_info_file(kitti_dir, max_sweeps=max_sweeps)
