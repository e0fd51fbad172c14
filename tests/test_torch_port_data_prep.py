"""The port's data preparation against the JAX package's, on raw trees the
tests write: the Waymo and KITTI info converters, the nuScenes / nuScenes
SSL / Lyft converters (through a small stand-in for the devkits, written
under the test's tmp dir and put on ``sys.path``, so that both packages'
unchanged code runs on it), the GT database and a GT-pasted sample read
from it, and the ``create_data`` entry point in process.  Every pickle,
``.bin`` file and sample is held bitwise to what ``geomae_tpu`` writes
from the same tree.  Numpy only: no JAX function is compiled."""
import os
import pickle
import sys
import textwrap

import numpy as np
import pytest

from geomae_tpu.data import converters as jconv
from geomae_tpu.data import dbsampler as jdb
from geomae_tpu.data import kitti_converter as jkc
from geomae_tpu.data import nuscenes as jnus
from geomae_tpu.data import synthetic as jsyn
from geomae_tpu.data import waymo_converter as jwc
from geomae_tpu_torch import create_data
from geomae_tpu_torch.data import converters as tconv
from geomae_tpu_torch.data import dbsampler as tdb
from geomae_tpu_torch.data import kitti_converter as tkc
from geomae_tpu_torch.data import nuscenes as tnus
from geomae_tpu_torch.data import waymo_converter as twc
from test_torch_port_data import assert_same, cfgs

SPLITS = ("train", "val", "trainval", "test")


def same_files(a: str, b: str, names) -> None:
    """The files ``names`` under directories ``a`` and ``b`` byte-equal."""
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _pose(tx, ty, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [tx, ty, 0.01 * tx]
    return T


def velo_to_cam():
    ext = _pose(1.2, -0.1, 0.05)
    ext[2, 3] = 1.5
    return twc.velo_to_front_cam(ext)


def write_waymo_tree(root: str, seed: int = 0) -> None:
    """A KITTI-format Waymo tree: two segments of 4 frames in
    ``training`` (prefix 0 and 1, the train / val split without
    ``ImageSets``), one of 2 in ``testing``; 6-channel frames, calib from
    ``format_calib``, poses, and ``label_all`` from
    ``waymo_label_to_kitti_line`` (a frame without labels among them)."""
    rng = np.random.default_rng(seed)
    T = velo_to_cam()
    calibs = [np.hstack([np.diag([2000.0 + i, 1990.0, 1.0]),
                         np.zeros((3, 1))]) for i in range(5)]
    frames = [("training", f"{p}000{f:03d}") for p in (0, 1) for f in range(4)]
    frames += [("testing", f"2000{f:03d}") for f in range(2)]
    for k, (split, fid) in enumerate(frames):
        sd = os.path.join(root, split)
        for sub in ("velodyne", "calib", "pose", "label_all"):
            os.makedirs(os.path.join(sd, sub), exist_ok=True)
        n = 300 + 10 * k
        pts = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                              rng.uniform(-1, 3, (n, 1)),
                              rng.uniform(0, 1, (n, 2)),
                              np.full((n, 1), 1e5 * (k + 1))], 1)
        boxes = [(*rng.uniform(-15, 15, 2), 0.8, *rng.uniform(1, 5, 3),
                  rng.uniform(-3, 3)) for _ in range(k % 3)]
        # a box over a cluster of the frame's points, so counts are > 0
        if boxes:
            b = boxes[0]
            pts[:40, :3] = np.array(b[:3]) + rng.uniform(-0.4, 0.4, (40, 3))
        pts.astype(np.float32).tofile(os.path.join(sd, "velodyne",
                                                   f"{fid}.bin"))
        np.savetxt(os.path.join(sd, "pose", f"{fid}.txt"),
                   _pose(0.5 * k, 0.1 * k, 0.02 * k))
        with open(os.path.join(sd, "calib", f"{fid}.txt"), "w") as f:
            f.write(twc.format_calib(calibs, [T] * 5))
        names = ("Car", "Pedestrian", "Cyclist")
        lines = [twc.waymo_label_to_kitti_line(
            names[j % 3], b, T, bbox2d=(1.234, 2.0, 30.5, 40.25),
            camera_id=str(j)) for j, b in enumerate(boxes)]
        if split == "training":
            with open(os.path.join(sd, "label_all", f"{fid}.txt"), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))


def write_kitti_tree(root: str, seed: int = 1) -> None:
    """A KITTI tree: 4-channel frames, calib text with P0-P3, R0_rect,
    Tr_velo_to_cam and Tr_imu_to_velo, 15-field ``label_2`` lines with a
    ``DontCare``, ``ImageSets`` train / val / test lists."""
    rng = np.random.default_rng(seed)
    T = velo_to_cam()
    ids = {"train": ["000000", "000002"], "val": ["000001"],
           "test": ["000003"]}
    os.makedirs(os.path.join(root, "ImageSets"))
    for name, fids in ids.items():
        with open(os.path.join(root, "ImageSets", f"{name}.txt"), "w") as f:
            f.write("\n".join(fids) + "\n")
        split = "testing" if name == "test" else "training"
        sd = os.path.join(root, split)
        for sub in ("velodyne", "calib", "label_2"):
            os.makedirs(os.path.join(sd, sub), exist_ok=True)
        for fid in fids:
            pts = np.concatenate([rng.uniform(-20, 20, (200, 3)),
                                  rng.uniform(0, 1, (200, 1))], 1)
            box = (*rng.uniform(-10, 10, 2), 0.5, 4.0, 1.8, 1.6, 0.3)
            pts[:30, :3] = np.array(box[:3]) + rng.uniform(-0.5, 0.5, (30, 3))
            pts.astype(np.float32).tofile(os.path.join(sd, "velodyne",
                                                       f"{fid}.bin"))
            P = np.hstack([np.diag([700.0, 710.0, 1.0]), np.zeros((3, 1))])
            lines = [f"P{i}: " + " ".join(f"{v:e}" for v in P.reshape(12))
                     for i in range(4)]
            lines.append("R0_rect: " + " ".join(
                f"{v:e}" for v in np.eye(3).reshape(9)))
            lines.append("Tr_velo_to_cam: " + " ".join(
                f"{v:e}" for v in T[:3].reshape(12)))
            lines.append("Tr_imu_to_velo: " + " ".join(
                f"{v:e}" for v in np.eye(4)[:3].reshape(12)))
            with open(os.path.join(sd, "calib", f"{fid}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            label = twc.waymo_label_to_kitti_line("Car", box, T)
            with open(os.path.join(sd, "label_2", f"{fid}.txt"), "w") as f:
                f.write(label.rsplit(" ", 1)[0] + "\n"
                        + "DontCare -1 -1 -10 0 0 1 1 -1 -1 -1 -1000 -1000 "
                        "-1000 -10\n")


# ---------------------------------------------------------------------------
# Waymo and KITTI
# ---------------------------------------------------------------------------


def test_waymo_label_and_calib_functions_match():
    T = velo_to_cam()
    assert np.array_equal(twc.cart_to_homo(T[:3]), jwc.cart_to_homo(T[:3]))
    assert np.array_equal(twc.cart_to_homo(T[:3, :3]),
                          jwc.cart_to_homo(T[:3, :3]))
    assert np.array_equal(twc.velo_to_front_cam(T), jwc.velo_to_front_cam(T))
    box = (12.34, -5.6, 1.22, 4.5, 1.9, 1.6, 0.7)
    line = twc.waymo_label_to_kitti_line("Car", box, T, (1, 2, 3, 4), "2")
    assert line == jwc.waymo_label_to_kitti_line("Car", box, T, (1, 2, 3, 4),
                                                 "2")
    assert_same(twc.parse_label(line + "\n" + line), jwc.parse_label(
        line + "\n" + line))
    # the label round trip through the port's own box decode
    from geomae_tpu_torch.data.waymo import _annos_to_lidar_boxes
    rec = _annos_to_lidar_boxes(twc.parse_label(line),
                                dict(R0_rect=np.eye(4), Tr_velo_to_cam=T))[0]
    want = [box[0], box[1], box[2] - box[5] / 2, *box[3:]]
    np.testing.assert_allclose(rec, want, atol=0.02)
    P = np.hstack([np.diag([1000.0, 1100.0, 1.0]), np.zeros((3, 1))])
    text = twc.format_calib([P] * 5, [T] * 5)
    assert text == jwc.format_calib([P] * 5, [T] * 5)
    calib = twc.parse_calib(text)
    assert_same(calib, jwc.parse_calib(text))
    np.testing.assert_allclose(calib["Tr_velo_to_cam"], T, atol=1e-5)
    kt = "\n".join(
        f"P{i}: " + " ".join(f"{v:e}" for v in P.reshape(12))
        for i in range(4)) + "\nR0_rect: 1 0 0 0 1 0 0 0 1\n"
    assert_same(tkc.parse_kitti_calib(kt), jkc.parse_kitti_calib(kt))


def test_complement_infos():
    infos = [dict(i=i) for i in range(11)]
    for k in (1, 3, 5):
        assert twc.complement_infos(infos, k) == jwc.complement_infos(infos,
                                                                      k)
    assert [x["i"] for x in twc.complement_infos(infos, 5)] == [
        1, 2, 3, 4, 6, 7, 8, 9]


def test_waymo_info_file_bitwise(tmp_path):
    """``create_waymo_info_file`` of both packages on one tree, and the
    ``waymo_infos`` entry point, which writes beside the tree."""
    root = str(tmp_path / "kitti_format")
    write_waymo_tree(root)
    jwc.create_waymo_info_file(root, save_path=str(tmp_path / "j"),
                               max_sweeps=2)
    twc.create_waymo_info_file(root, save_path=str(tmp_path / "t"),
                               max_sweeps=2)
    names = [f"waymo_infos_{s}.pkl" for s in SPLITS]
    same_files(str(tmp_path / "j"), str(tmp_path / "t"), names)
    create_data.main(["waymo_infos", "--root-path", root,
                      "--max-sweeps", "2"])
    same_files(str(tmp_path / "j"), root, names)
    with open(os.path.join(root, "waymo_infos_train.pkl"), "rb") as f:
        train = pickle.load(f)
    with open(os.path.join(root, "waymo_infos_val.pkl"), "rb") as f:
        val = pickle.load(f)
    assert [i["image"]["image_idx"] for i in train] == [0, 1, 2, 3]
    assert [i["image"]["image_idx"] for i in val] == [1000000 + f
                                                      for f in range(4)]
    assert [len(i["sweeps"]) for i in train] == [0, 1, 2, 2]
    counts = np.concatenate([i["annos"]["num_points_in_gt"] for i in train])
    assert len(counts) and counts.max() >= 40


def test_kitti_info_file_bitwise(tmp_path):
    """``create_kitti_info_file`` and the ``kitti`` entry point."""
    root = str(tmp_path / "kitti")
    write_kitti_tree(root)
    jkc.create_kitti_info_file(root, save_path=str(tmp_path / "j"))
    create_data.main(["kitti", "--root-path", root, "--out-dir",
                      str(tmp_path / "t")])
    same_files(str(tmp_path / "j"), str(tmp_path / "t"),
               [f"kitti_infos_{s}.pkl" for s in SPLITS])
    with open(tmp_path / "t" / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    assert [i["image"]["image_idx"] for i in infos] == [0, 2]
    # the documented deviation: no image-FOV crop in the count
    assert list(infos[0]["annos"]["name"]) == ["Car", "DontCare"]
    assert infos[0]["annos"]["num_points_in_gt"][0] >= 30


# ---------------------------------------------------------------------------
# nuScenes, nuScenes SSL and Lyft on a stand-in devkit
# ---------------------------------------------------------------------------

FAKE_NUSCENES = '''
import os
import numpy as np
from pyquaternion import Quaternion
from nuscenes.utils.data_classes import Box


def _quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


class NuScenes:
    """The table API of the devkit over a seeded world: 2 scenes of 3 key
    frames, 2 sweeps between key frames, 3 annotations a key frame."""

    def __init__(self, version="v1.0-trainval", dataroot="", verbose=True,
                 scenes=("scene-0001", "scene-0002", "scene-0003")):
        rng = np.random.default_rng(7)
        self.dataroot = dataroot
        self.tables = {k: {} for k in ("sample_data", "ego_pose",
                                       "calibrated_sensor",
                                       "sample_annotation")}
        self.scene, self.sample, self._boxes, self._vel = [], [], {}, {}
        cs = dict(token="cs0", translation=[0.9, 0.0, 1.8],
                  rotation=_quat(0.01))
        self.tables["calibrated_sensor"]["cs0"] = cs
        prev, ts = "", 1_000_000
        cats = ["vehicle.car", "human.pedestrian.adult", "vehicle.bus.rigid",
                "movable_object.barrier", "animal"]
        for si, name in enumerate(scenes):
            self.scene.append(dict(name=name, token=f"scene{si}"))
            prev = ""
            for k in range(7):
                key = k % 3 == 0
                tok = f"sd{si}_{k}"
                ts += 50_000
                self.tables["ego_pose"][f"ep{si}_{k}"] = dict(
                    translation=list(rng.uniform(-5, 5, 3)),
                    rotation=_quat(rng.uniform(-1, 1)))
                self.tables["sample_data"][tok] = dict(
                    token=tok, ego_pose_token=f"ep{si}_{k}",
                    calibrated_sensor_token="cs0", prev=prev,
                    is_key_frame=key, timestamp=ts,
                    filename=f"samples/LIDAR_TOP/{tok}.bin")
                prev = tok
                if not key:
                    continue
                anns = []
                for j in range(3):
                    at = f"ann{si}_{k}_{j}"
                    anns.append(at)
                    self.tables["sample_annotation"][at] = dict(
                        category_name=cats[int(rng.integers(0, len(cats)))],
                        num_lidar_pts=int(rng.integers(0, 3)),
                        num_radar_pts=int(rng.integers(0, 2)))
                    self._boxes[at] = Box(
                        rng.uniform(-30, 30, 3), rng.uniform(0.5, 5, 3),
                        Quaternion(_quat(rng.uniform(-3, 3))),
                        name=cats[j])
                    v = rng.uniform(-3, 3, 3)
                    if j == 2:
                        v[0] = np.nan
                    self._vel[at] = v
                self.sample.append(dict(
                    token=f"s{si}_{k}", scene_token=f"scene{si}",
                    timestamp=ts, data=dict(LIDAR_TOP=tok), anns=anns))

    def get(self, table, token):
        return self.tables[table][token]

    def get_sample_data_path(self, token):
        return os.path.join(self.dataroot,
                            self.tables["sample_data"][token]["filename"])

    def get_sample_data(self, token):
        sample = next(s for s in self.sample
                      if s["data"]["LIDAR_TOP"] == token)
        return (self.get_sample_data_path(token),
                [self._boxes[a] for a in sample["anns"]], None)

    def box_velocity(self, ann_token):
        return self._vel[ann_token]
'''

FAKE_FILES = {
    "pyquaternion/__init__.py": '''
import numpy as np


class Quaternion:
    def __init__(self, q):
        self.w, self.x, self.y, self.z = (float(v) for v in q)

    @property
    def rotation_matrix(self):
        w, x, y, z = self.w, self.x, self.y, self.z
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])

    @property
    def yaw_pitch_roll(self):
        w, x, y, z = self.w, self.x, self.y, self.z
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        return yaw, pitch, roll
''',
    "nuscenes/__init__.py": "",
    "nuscenes/nuscenes.py": FAKE_NUSCENES,
    "nuscenes/utils/__init__.py": "",
    "nuscenes/utils/splits.py": '''
train = ["scene-0001", "scene-0003"]
val = ["scene-0002"]
mini_train, mini_val = ["scene-0001"], ["scene-0002"]
test = ["scene-0001", "scene-0002", "scene-0003"]
''',
    "nuscenes/utils/data_classes.py": '''
import numpy as np


class Box:
    def __init__(self, center, wlh, orientation, name=None):
        self.center = np.asarray(center, float)
        self.wlh = np.asarray(wlh, float)
        self.orientation = orientation
        self.name = name
''',
    "lyft_dataset_sdk/__init__.py": "",
    "lyft_dataset_sdk/lyftdataset.py": '''
from nuscenes.nuscenes import NuScenes


class LyftDataset(NuScenes):
    def __init__(self, data_path, json_path, verbose=True):
        super().__init__("lyft", data_path, verbose,
                         scenes=("host-a", "host-b", "host-c"))
''',
}
DEVKITS = ("nuscenes", "pyquaternion", "lyft_dataset_sdk")


def _drop_devkits() -> None:
    for m in [m for m in sys.modules if m.split(".")[0] in DEVKITS]:
        del sys.modules[m]


@pytest.fixture()
def fake_devkit(tmp_path, monkeypatch):
    """The stand-in packages on ``sys.path`` for one test."""
    base = tmp_path / "devkit"
    for rel, text in FAKE_FILES.items():
        path = base / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    _drop_devkits()
    monkeypatch.syspath_prepend(str(base))
    yield
    _drop_devkits()


@pytest.mark.parametrize("task,version", [
    ("nuscenes", "v1.0-trainval"), ("nuscenes_ssl", "v1.0-trainval"),
    ("nuscenes", "v1.0-mini"), ("lyft", "v1.01-train")])
def test_nuscenes_and_lyft_infos_bitwise(fake_devkit, tmp_path, task,
                                         version):
    """The JAX converter into one directory, the port's entry point into
    another, byte-equal pickles; the SSL set adds the intermediate sweeps
    of the train scenes."""
    root = str(tmp_path / "raw")
    os.makedirs(root)
    if task == "lyft":
        for name, scenes in (("train", ["host-a", "host-c"]),
                             ("val", ["host-b"])):
            with open(os.path.join(root, f"{name}.txt"), "w") as f:
                f.write("\n".join(scenes) + "\n")
        jconv.create_lyft_infos(root, str(tmp_path / "j"), version=version,
                                max_sweeps=3)
        names = ["lyft_infos_train.pkl", "lyft_infos_val.pkl"]
    else:
        jconv.create_nuscenes_infos(root, str(tmp_path / "j"),
                                    version=version, max_sweeps=3,
                                    ssl=task == "nuscenes_ssl")
        suffix = "_ssl" if task == "nuscenes_ssl" else ""
        names = [f"nuscenes{suffix}_infos_{s}.pkl" for s in ("train", "val")]
    create_data.main([task, "--root-path", root, "--out-dir",
                      str(tmp_path / "t"), "--version", version,
                      "--max-sweeps", "3"])
    same_files(str(tmp_path / "j"), str(tmp_path / "t"), names)
    with open(tmp_path / "t" / names[0], "rb") as f:
        train = pickle.load(f)["infos"]
    keys = 3 if "mini" in version else 6       # key frames of train scenes
    extra = 4 * 2 if task == "nuscenes_ssl" else 0   # 2 sweeps x 2 gaps
    assert len(train) == keys + extra
    assert max(len(i["sweeps"]) for i in train) == 3
    if task != "nuscenes_ssl":
        assert all(np.isfinite(i["gt_velocity"]).all() for i in train)


@pytest.mark.parametrize("task", ["nuscenes", "nuscenes_ssl", "lyft",
                                  "waymo"])
def test_devkit_tasks_raise_import_error(task, tmp_path, monkeypatch):
    """Without the devkits each task raises the JAX package's ImportError
    (a ``None`` in ``sys.modules`` makes an import fail at once)."""
    for m in DEVKITS + ("tensorflow", "waymo_open_dataset"):
        monkeypatch.setitem(sys.modules, m, None)
    # a raw split for the Waymo converter to reach the devkit on
    os.makedirs(tmp_path / "waymo_format" / "training")
    argv = [task, "--root-path", str(tmp_path), "--out-dir",
            str(tmp_path / "out")]
    with pytest.raises(ImportError) as got:
        create_data.main(argv)
    fn = {"waymo": lambda: jwc.convert_waymo_raw(str(tmp_path),
                                                 str(tmp_path / "j")),
          "lyft": lambda: jconv.create_lyft_infos(str(tmp_path),
                                                  str(tmp_path / "j"))}.get(
        task, lambda: jconv.create_nuscenes_infos(str(tmp_path),
                                                  str(tmp_path / "j")))
    with pytest.raises(ImportError) as want:
        fn()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the GT database and GT paste
# ---------------------------------------------------------------------------


def test_gt_database_and_paste_bitwise(tmp_path):
    """``create_groundtruth_database`` of both packages on one info file
    (boxes named from every class and one unknown): the ``.bin`` files
    and the dbinfos byte-equal; then a GT-pasted detection sample read
    from the port's database equals the JAX one's from its own."""
    nus = str(tmp_path / "nus")
    jsyn.write_synthetic_infos(nus, n_frames=3, n_points=6000, n_sweeps=2)
    rng = np.random.default_rng(3)
    infos = jnus.load_infos(os.path.join(nus, "infos.pkl"))
    names = np.array(list(jnus.NUS_CLASSES) + ["animal"])
    for info in infos:
        info["gt_names"] = names[rng.integers(0, len(names),
                                              len(info["gt_boxes"]))]
    with open(os.path.join(nus, "named.pkl"), "wb") as f:
        pickle.dump(dict(infos=infos, metadata=dict(version="t")), f)
    jconv.create_groundtruth_database(nus, "named.pkl", str(tmp_path / "j"))
    create_data.main(["gt_database", "--root-path", nus, "--ann-file",
                      "named.pkl", "--out-dir", str(tmp_path / "t")])
    bins = sorted(os.listdir(tmp_path / "j" / "gt_database"))
    assert bins == sorted(os.listdir(tmp_path / "t" / "gt_database"))
    assert len(bins) == sum(n in jnus.NUS_CLASSES for i in infos
                            for n in i["gt_names"])
    same_files(str(tmp_path / "j"), str(tmp_path / "t"),
               ["nuscenes_dbinfos_train.pkl"]
               + [os.path.join("gt_database", b) for b in bins])

    jc, tc = cfgs("geomae_finetune_nus", data_root=nus, ann_file="named.pkl",
                  sweeps_num=2)
    groups = dict(car=14, pedestrian=3, bus=3)
    samplers = [mod.DataBaseSampler(str(tmp_path / d), str(
        tmp_path / d / "nuscenes_dbinfos_train.pkl"), jnus.NUS_CLASSES,
        sample_groups=groups, min_points=1)
        for mod, d in ((jdb, "j"), (tdb, "t"))]
    j = jnus.NuScenesDetDataset(jc.data, jc.voxel, jc.caps, 96,
                                db_sampler=samplers[0])
    t = tnus.NuScenesDetDataset(tc.data, tc.voxel, tc.caps, 96,
                                db_sampler=samplers[1])
    plain = tnus.NuScenesDetDataset(tc.data, tc.voxel, tc.caps, 96)
    pasted = []
    for idx, seed in ((0, 1), (1, 4), (2, 9)):
        got = t.__getitem__(idx, seed=seed)
        assert_same(got, j.__getitem__(idx, seed=seed))
        pasted.append(int(got["gt_mask"].sum()) - int(plain.__getitem__(
            idx, seed=seed)["gt_mask"].sum()))
    print("objects pasted per sample", pasted)
    assert min(pasted) >= 0 and sum(pasted) > 0
