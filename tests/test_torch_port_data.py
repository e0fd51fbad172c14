"""The port's data layer against the JAX package's, on files the tests
write themselves: every sample held bitwise to the JAX dataset for the
same files, index and seed.  The point IO and each transform, the
nuScenes SSL dataset (native C++ and numpy, train and test mode, the host
scene), the detection set (train and test, ``valid_flag``), CBGS, Lyft,
the Waymo / KITTI / Waymo SSL sets on KITTI-format infos, GT-database
paste, and ``write_synthetic_infos``.  Also: the host scene against the
port's ``build_scene_batch`` per (pillar, slot) group (ROADMAP R3), one
tiny pretrain step from a host scene against the step from points (and
host-scene batches through the loader, ``shard_batch`` and the
``Trainer``), and the native library's build (the port's own, a failed
build raises)."""
import ctypes
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import geomae_tpu.config as jcfg
import geomae_tpu_torch.config as tcfg
from geomae_tpu.data import dbsampler as jdb
from geomae_tpu.data import native_prep as jnp_prep
from geomae_tpu.data import nuscenes as jnus
from geomae_tpu.data import pointcloud as jpc
from geomae_tpu.data import synthetic as jsyn
from geomae_tpu.data import transforms as jT
from geomae_tpu.data import waymo as jway
from geomae_tpu_torch.data import _native
from geomae_tpu_torch.data import dbsampler as tdb
from geomae_tpu_torch.data import native_prep as tnp_prep
from geomae_tpu_torch.data import nuscenes as tnus
from geomae_tpu_torch.data import pointcloud as tpc
from geomae_tpu_torch.data import synthetic as tsyn
from geomae_tpu_torch.data import transforms as tT
from geomae_tpu_torch.data import waymo as tway
from geomae_tpu_torch.data.loader import PrefetchLoader
from geomae_tpu_torch.ops.voxelize import build_scene_batch
from geomae_tpu_torch.parallel.mesh import shard_batch
from geomae_tpu_torch.train import pretrain as PT
from geomae_tpu_torch.train.trainer import Trainer

PAIRS = [(0, 1), (1, 7), (3, 12345)]         # (idx, seed)


def assert_same(a, b):
    """Two samples (dicts of arrays, or arrays) bitwise equal: keys,
    dtypes, shapes and bytes."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape)
    assert a.tobytes() == b.tobytes()


def cfgs(preset, caps=(8192, 1024, 512), **data):
    """The same config from both packages: ``preset``'s, with small caps
    and the given data fields."""
    out = []
    for C in (jcfg, tcfg):
        cfg = getattr(C, preset)()
        out.append(dataclasses.replace(
            cfg, caps=dataclasses.replace(cfg.caps, max_points=caps[0],
                                          max_voxels=caps[1],
                                          max_visible=caps[2]),
            data=dataclasses.replace(cfg.data, **data)))
    return out


@pytest.fixture(scope="module")
def nus(tmp_path_factory):
    """nuScenes-schema frames by the JAX writer: 5 frames of 4,000 points,
    3 sweeps each."""
    root = str(tmp_path_factory.mktemp("nus"))
    jsyn.write_synthetic_infos(root, n_frames=5, n_points=4000, n_sweeps=3)
    return root


def labelled_infos(root, seed=0):
    """The frames' infos with names drawn from every nuScenes class and
    one unknown, and a random ``valid_flag``."""
    rng = np.random.default_rng(seed)
    infos = jnus.load_infos(os.path.join(root, "infos.pkl"))
    names = np.array(list(jnus.NUS_CLASSES) + ["animal"])
    for info in infos:
        n = len(info["gt_boxes"])
        info["gt_names"] = names[rng.integers(0, len(names), n)]
        info["valid_flag"] = rng.random(n) < 0.8
    return infos


def write_waymo_infos(root, n_frames=4, n_points=3000, n_sweeps=3,
                      seed=0, key_points=None):
    """A KITTI-format Waymo tree under ``root``: 6-channel ``velodyne``
    frames (x y z intensity elongation timestamp) of ``n_points`` points
    (the key frames ``key_points``, where given) in +-10 m, a slowly
    moving ego pose per frame, key frames with ``n_sweeps`` sweeps (the
    earlier frames, with pose and timestamp; one sweep whose file is
    missing), camera-frame ``annos`` with the three classes and one
    other, and ``calib``.  Returns the info pickle's name."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    tr = np.array([[0, -1, 0, 0.02], [0, 0, -1, -0.1], [1, 0, 0, -0.3],
                   [0, 0, 0, 1]], np.float64)
    rect = np.eye(4)
    th = 0.01
    rect[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]]
    poses, infos = [], []
    for i in range(n_frames + n_sweeps):
        pose = np.eye(4)
        a = 0.02 * i
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]]
        pose[:3, 3] = [0.5 * i, 0.1 * i, 0.01 * i]
        poses.append(pose)
        n = n_points if key_points is None or i < n_sweeps else key_points
        pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                        rng.uniform(-1.5, 2.0, n), rng.uniform(0, 1, n),
                        rng.uniform(0, 1, n), np.full(n, 0.1 * i)],
                       -1).astype(np.float32)
        pts.tofile(os.path.join(root, "velodyne", f"{i:06d}.bin"))
    names = np.array(["Car", "Pedestrian", "Cyclist", "Sign"])
    for i in range(n_sweeps, n_frames + n_sweeps):
        sweeps = [dict(velodyne_path=f"velodyne/{i - 1 - j:06d}.bin",
                       pose=poses[i - 1 - j], timestamp=(i - 1 - j) * 100_000)
                  for j in range(n_sweeps)]
        sweeps.append(dict(velodyne_path="velodyne/missing.bin",
                           pose=poses[i], timestamp=i * 100_000))
        m = 6
        infos.append(dict(
            point_cloud=dict(velodyne_path=f"velodyne/{i:06d}.bin",
                             num_features=6),
            pose=poses[i], timestamp=i * 100_000, sweeps=sweeps,
            calib=dict(R0_rect=rect, Tr_velo_to_cam=tr),
            annos=dict(
                name=names[rng.integers(0, 4, m)],
                location=rng.uniform([-8, 0.5, 2], [8, 1.5, 9], (m, 3)),
                dimensions=rng.uniform([1, 1, 0.5], [5, 2, 2.5], (m, 3)),
                rotation_y=rng.uniform(-np.pi, np.pi, m))))
    with open(os.path.join(root, "waymo_infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return "waymo_infos_train.pkl"


@pytest.fixture(scope="module")
def waymo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    return root, write_waymo_infos(root)


# ---------------------------------------------------------------------------
# the writer, the point IO and the transforms
# ---------------------------------------------------------------------------


def test_write_synthetic_infos_writes_the_jax_bytes(tmp_path):
    """Every .bin file and the pickle, byte for byte (the two roots have
    names of one length, so the pickles differ only in the root)."""
    a, b = tmp_path / "jax", tmp_path / "prt"
    ja = jsyn.write_synthetic_infos(str(a), n_frames=2, n_points=1500)
    tb = tsyn.write_synthetic_infos(str(b), n_frames=2, n_points=1500)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert len(files) == 2 * 3 + 1
    for f in files:
        want = (a / f).read_bytes()
        if f.suffix == ".pkl":
            want = want.replace(str(a).encode(), str(b).encode())
        assert (b / f).read_bytes() == want, f
    assert os.path.basename(ja) == os.path.basename(tb) == "infos.pkl"


def test_pointcloud_io_and_merge(nus, tmp_path):
    info = jnus.load_infos(os.path.join(nus, "infos.pkl"))[2]
    assert_same(tpc.load_points_bin(info["lidar_path"], 5, 4),
                jpc.load_points_bin(info["lidar_path"], 5, 4))
    pts = np.random.default_rng(0).uniform(-3, 3, (500, 5)) \
        .astype(np.float32)
    assert_same(tpc.remove_close(pts, 1.0), jpc.remove_close(pts, 1.0))
    for kw in (dict(sweeps_num=9), dict(sweeps_num=2, test_mode=True),
               dict(sweeps_num=2, test_mode=False)):
        for seed in (0, 5):
            assert_same(
                tpc.merge_sweeps(info, nus, rng=np.random.default_rng(seed),
                                 **kw),
                jpc.merge_sweeps(info, nus, rng=np.random.default_rng(seed),
                                 **kw))
    bare = dict(info, sweeps=[])              # empty sweeps: padded copies
    assert_same(tpc.merge_sweeps(bare, nus, sweeps_num=3),
                jpc.merge_sweeps(bare, nus, sweeps_num=3))
    # a path that embeds its own root prefix resolves under data_root
    name = os.path.basename(info["lidar_path"])
    for path in (f"data/nuscenes/{name}", name, info["lidar_path"],
                 "data/nowhere.bin"):
        assert tpc._abspath(path, nus) == jpc._abspath(path, nus)
        assert tpc._abspath(path, "") == jpc._abspath(path, "")


def transformed(T, seed, pts, boxes, labels):
    """Each transform of the package ``T`` in the train pipeline's order,
    one generator throughout, and each padding."""
    g = np.random.default_rng(seed)
    s = dict(points=pts, boxes=boxes, labels=labels)
    s = T.global_rot_scale_trans(s, g, (-0.4, 0.4), (0.9, 1.1),
                                 (0.2, 0.2, 0.1))
    s = T.random_flip_3d(s, g, 0.5, 0.5)
    s = T.points_range_filter(s, (-51.2, -51.2, -5, 51.2, 51.2, 3))
    s = T.object_range_filter(s, (-51.2, -51.2, -5, 51.2, 51.2, 3))
    s = T.point_shuffle(s, g)
    return [s, *T.pad_points(s["points"], 2048, g),
            *T.pad_points(s["points"], 4096),
            *T.pad_boxes(s["boxes"], s["labels"], 16),
            T.rotation_z(0.1 * seed),
            T.random_flip_3d(dict(points=pts), g, 1.0, 1.0)]


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("cols", [7, 9])
def test_transforms(seed, cols):
    """Boxes with and without velocity columns."""
    rng = np.random.default_rng(100 + seed)
    pts = rng.uniform(-60, 60, (3000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-6, 4, 3000)
    boxes = rng.uniform(-55, 55, (20, cols)).astype(np.float32)
    labels = rng.integers(0, 10, 20).astype(np.int32)
    for a, b in zip(transformed(tT, seed, pts, boxes, labels),
                    transformed(jT, seed, pts, boxes, labels)):
        assert_same(a, b)


# ---------------------------------------------------------------------------
# nuScenes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("test_mode", [False, True])
def test_ssl_dataset(nus, native, test_mode):
    jc, tc = cfgs("geomae_pretrain_nus", data_root=nus, ann_file="infos.pkl",
                  sweeps_num=2)
    j = jnus.NuScenesSSLDataset(jc.data, jc.voxel, jc.caps, test_mode,
                                native=native)
    t = tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps, test_mode,
                                native=native)
    assert len(t) == len(j) == 5
    for idx, seed in PAIRS:
        s = t.__getitem__(idx, seed=seed)
        assert_same(s, j.__getitem__(idx, seed=seed))
    assert 5000 < s["point_valid"].sum() < 8192


def test_ssl_dataset_overflows_the_cap_alike(nus):
    """More points than the cap: the numpy path keeps a random subset."""
    jc, tc = cfgs("geomae_pretrain_nus", caps=(3000, 1024, 512),
                  data_root=nus, ann_file="infos.pkl")
    for native in (True, False):
        j = jnus.NuScenesSSLDataset(jc.data, jc.voxel, jc.caps,
                                    native=native)
        t = tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps,
                                    native=native)
        s = t.__getitem__(4, seed=9)
        assert_same(s, j.__getitem__(4, seed=9))
        assert s["point_valid"].all()


def test_precompute_scene(nus):
    """The host-sorted scene of a native sample, field by field."""
    jc, tc = cfgs("geomae_pretrain_nus", data_root=nus, ann_file="infos.pkl")
    j = jnus.NuScenesSSLDataset(jc.data, jc.voxel, jc.caps,
                                precompute_scene=True)
    t = tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps,
                                precompute_scene=True)
    for idx, seed in PAIRS:
        s = t.__getitem__(idx, seed=seed)
        assert_same(s, j.__getitem__(idx, seed=seed))
    assert {"p2v", "coords", "table_valid", "num_voxels"} <= s.keys()
    with pytest.raises(ValueError, match="native"):
        tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps, native=False,
                                precompute_scene=True)


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("use_valid_flag", [True, False])
def test_det_dataset(nus, test_mode, use_valid_flag):
    jc, tc = cfgs("geomae_finetune_nus", data_root=nus, ann_file="infos.pkl",
                  sweeps_num=2)
    infos = labelled_infos(nus)
    j = jnus.NuScenesDetDataset(jc.data, jc.voxel, jc.caps, 64, test_mode,
                                infos=infos, use_valid_flag=use_valid_flag)
    t = tnus.NuScenesDetDataset(tc.data, tc.voxel, tc.caps, 64, test_mode,
                                infos=infos, use_valid_flag=use_valid_flag)
    for idx, seed in PAIRS:
        assert_same(t.__getitem__(idx, seed=seed),
                    j.__getitem__(idx, seed=seed))
        for a, b in zip(t.get_ann(idx), j.get_ann(idx)):
            assert_same(a, b)
        assert t.cat_ids(idx) == j.cat_ids(idx)
    # the infos file itself, read by both
    j = jnus.NuScenesDetDataset(jc.data, jc.voxel, jc.caps, 64, test_mode)
    t = tnus.NuScenesDetDataset(tc.data, tc.voxel, tc.caps, 64, test_mode)
    assert_same(t.__getitem__(2, seed=4), j.__getitem__(2, seed=4))


def test_cbgs_indices_and_samples(nus):
    """A multi-class set: the balanced indices, then samples through
    them; and the one-class set of ``write_synthetic_infos`` (all cars)
    keeps int(0.1 n) rows."""
    jc, tc = cfgs("geomae_finetune_nus", data_root=nus, ann_file="infos.pkl",
                  sweeps_num=1)
    infos = labelled_infos(nus, seed=3) * 4
    j = jnus.CBGSDataset(jnus.NuScenesDetDataset(jc.data, jc.voxel, jc.caps,
                                                 64, infos=infos))
    t = tnus.CBGSDataset(tnus.NuScenesDetDataset(tc.data, tc.voxel, tc.caps,
                                                 64, infos=infos))
    assert t.indices == j.indices and len(t) > len(infos)
    for idx, seed in PAIRS:
        assert_same(t.__getitem__(idx, seed=seed),
                    j.__getitem__(idx, seed=seed))
    cars = tnus.CBGSDataset(tnus.NuScenesDetDataset(
        tc.data, tc.voxel, tc.caps, 64,
        infos=tnus.load_infos(os.path.join(nus, "infos.pkl")) * 4))
    assert len(cars) == 2                      # int(0.1 x 20)


def test_lyft_dataset(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "lidar0.bin"
    rng.uniform(-5, 5, (300, 5)).astype(np.float32).tofile(path)
    infos = [dict(lidar_path=str(path), timestamp=0, sweeps=[], token="t0",
                  gt_boxes=np.array([[1, 2, 0, 4, 2, 1.5, 0.3],
                                     [-1, 1, 0, 2, 1, 1, 0.1]], np.float32),
                  gt_names=np.array(["emergency_vehicle", "car"]))]
    jc, tc = cfgs("geomae_finetune_nus", data_root=str(tmp_path),
                  sweeps_num=0)
    j = jnus.LyftDataset(jc.data, jc.voxel, jc.caps, 8, infos=infos)
    t = tnus.LyftDataset(tc.data, tc.voxel, tc.caps, 8, infos=infos)
    assert t.CLASSES == j.CLASSES == jnus.LYFT_CLASSES
    for seed in (1, 2):
        s = t.__getitem__(0, seed=seed)
        assert_same(s, j.__getitem__(0, seed=seed))
    assert s["gt_mask"].sum() == 2 and s["gt_boxes"].shape[-1] == 9
    assert tnus.NAME_MAPPING == jnus.NAME_MAPPING
    assert tnus.NUS_CLASSES == jnus.NUS_CLASSES


# ---------------------------------------------------------------------------
# Waymo and KITTI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["WaymoDataset", "KittiDataset",
                                  "WaymoSSLDataset"])
@pytest.mark.parametrize("test_mode", [False, True])
def test_waymo_datasets(waymo, kind, test_mode):
    """Pose-relative sweeps (f64), a missing sweep skipped, camera-frame
    annos through ``calib``; KITTI on the same infos with their channels
    (its default 4-channel frames crash in both packages: ROADMAP R5)."""
    root, ann = waymo
    jc, tc = cfgs("tiny_pretrain_waymo_config", caps=(16384, 512, 256),
                  data_root=root, ann_file=ann)
    kw = dict(load_dims=6, use_dims=5)
    j = getattr(jway, kind)(jc.data, jc.voxel, jc.caps, 32, test_mode, **kw)
    t = getattr(tway, kind)(tc.data, tc.voxel, tc.caps, 32, test_mode, **kw)
    assert len(t) == len(j) == 4
    for idx, seed in PAIRS:
        s = t.__getitem__(idx, seed=seed)
        assert_same(s, j.__getitem__(idx, seed=seed))
        for a, b in zip(t.get_ann(idx), j.get_ann(idx)):
            assert_same(a, b)
    assert s["point_valid"].sum() > 3000 * 3
    assert_same(tway.load_waymo_infos(os.path.join(root, ann))[0]["pose"],
                jway.load_waymo_infos(os.path.join(root, ann))[0]["pose"])


def test_annos_to_lidar_boxes(waymo):
    root, ann = waymo
    for info in jway.load_waymo_infos(os.path.join(root, ann)):
        assert_same(tway._annos_to_lidar_boxes(info["annos"], info["calib"]),
                    jway._annos_to_lidar_boxes(info["annos"], info["calib"]))
    empty = dict(location=np.zeros((0, 3)), dimensions=np.zeros((0, 3)),
                 rotation_y=np.zeros(0))
    assert tway._annos_to_lidar_boxes(empty, {}).shape == (0, 7)


# ---------------------------------------------------------------------------
# GT-database paste
# ---------------------------------------------------------------------------


def test_db_sampler(nus, tmp_path):
    """A GT database of object clouds, pasted into training frames through
    the detection set, and straight into a sample."""
    rng = np.random.default_rng(5)
    db = {}
    os.makedirs(tmp_path / "gt", exist_ok=True)
    for c, name in enumerate(("car", "pedestrian", "bus", "barrier")):
        db[name] = []
        for k in range(6):
            obj = rng.normal(0, 0.5, (40 + 10 * k, 5)).astype(np.float32)
            rel = f"gt/{name}_{k}.bin"
            obj.tofile(tmp_path / rel)
            # bottoms inside the ground layer (z about -1.8), so that the
            # removal of scene points below a pasted box's bottom shows
            box = [*rng.uniform(-40, 40, 2), -1.8, *rng.uniform(3, 8, 2),
                   rng.uniform(1, 3), rng.uniform(-3, 3)]
            db[name].append(dict(path=rel, box3d_lidar=np.array(box),
                                 num_points_in_gt=3 + k))
    db["car"].append(dict(path="gt/none.bin", num_points_in_gt=50,
                          box3d_lidar=np.array([30, 30, -1, 4, 2, 1.5, 0,
                                                0, 0])))
    with open(tmp_path / "dbinfos.pkl", "wb") as f:
        pickle.dump(db, f)
    args = (str(tmp_path), str(tmp_path / "dbinfos.pkl"), jnus.NUS_CLASSES)
    js, ts = jdb.DataBaseSampler(*args), tdb.DataBaseSampler(*args)
    jc, tc = cfgs("geomae_finetune_nus", data_root=nus, ann_file="infos.pkl",
                  sweeps_num=1)
    infos = labelled_infos(nus, seed=1)
    j = jnus.NuScenesDetDataset(jc.data, jc.voxel, jc.caps, 96, infos=infos,
                                db_sampler=js)
    t = tnus.NuScenesDetDataset(tc.data, tc.voxel, tc.caps, 96, infos=infos,
                                db_sampler=ts)
    for idx, seed in PAIRS:
        assert_same(t.__getitem__(idx, seed=seed),
                    j.__getitem__(idx, seed=seed))
    boxes, labels = t.get_ann(0)
    pts = tpc.merge_sweeps(infos[0], nus, sweeps_num=1)
    sample = dict(points=pts, boxes=boxes, labels=labels)
    got = ts(sample, np.random.default_rng(2))
    assert_same(got, js(sample, np.random.default_rng(2)))
    assert len(got["boxes"]) > len(boxes)
    assert_same(tdb._bev_collide(boxes, boxes), jdb._bev_collide(boxes, boxes))


# ---------------------------------------------------------------------------
# the native library and the host scene
# ---------------------------------------------------------------------------


def test_native_library_is_the_ports_own(tmp_path):
    """Built from the port's source into build/geomae_tpu_torch, never the
    JAX package's library; a missing or failing compiler raises."""
    lib = _native.library()
    path = _native.library_path()
    assert path.parent.name == "geomae_tpu_torch" and path.exists()
    assert _native.SOURCE.parent.parent.name == "geomae_tpu_torch"
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    with pytest.raises(RuntimeError, match="no compiler"):
        _native.build(tmp_path / "lib.so", cxx=str(tmp_path / "no-g++"))
    with pytest.raises(RuntimeError, match="failed"):
        _native.build(tmp_path / "lib.so", cxx="false")
    assert not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="prep_sweep"):
        _native.prep_sweep(np.zeros((4, 4), np.float32),
                           np.zeros((8, 5), np.float32), ctypes.c_int64(0),
                           None, None, 0.0, 1.0, 0.0, 1.0, False, False,
                           None)


def test_native_prep_functions(nus):
    jc, tc = cfgs("geomae_pretrain_nus", data_root=nus, ann_file="infos.pkl")
    info = jnus.load_infos(os.path.join(nus, "infos.pkl"))[1]
    for train in (True, False):
        assert tnp_prep.sample_aug_params(
            tc.data, np.random.default_rng(3), train) == \
            jnp_prep.sample_aug_params(jc.data, np.random.default_rng(3),
                                       train)
        assert_same(
            tnp_prep.prepare_ssl_sample(info, tc.data, tc.voxel, tc.caps,
                                        np.random.default_rng(8), train),
            jnp_prep.prepare_ssl_sample(info, jc.data, jc.voxel, jc.caps,
                                        np.random.default_rng(8), train))


@pytest.mark.parametrize("seed", [0, 1])
def test_host_scene_matches_build_scene_batch(nus, seed):
    """``build_scene_host`` against the port's device sort (run on the
    CPU): the table exactly, and the points per (pillar, slot) group
    (R3), on a sample whose pillars overflow a small cap."""
    _, tc = cfgs("geomae_pretrain_nus", caps=(8192, 400, 128),
                 data_root=nus, ann_file="infos.pkl")
    s = tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps).__getitem__(
        seed, seed=seed)
    n = int(s["point_valid"].sum())
    host = tnp_prep.build_scene_host(s["points"], n, tc.voxel, 400)
    assert_same(host, jnp_prep.build_scene_host(s["points"], n, tc.voxel,
                                                400))
    dev = build_scene_batch(torch.from_numpy(s["points"])[None],
                            torch.from_numpy(s["point_valid"])[None],
                            tc.voxel, 400)
    t = dev.table
    assert host["num_voxels"] == int(t.num_voxels[0]) > 400
    for k, v in (("coords", t.coords), ("table_valid", t.valid),
                 ("p2v", t.point2voxel), ("point_valid", dev.valid),
                 ("slot_low", dev.slot_low), ("slot_med", dev.slot_med),
                 ("slot_sort", dev.slot_sort)):
        np.testing.assert_array_equal(host[k], v[0].numpy(), err_msg=k)
    key = host["p2v"].astype(np.int64) * 128 + host["slot_sort"]
    ph, pd = host["points"][:n], dev.points[0, :n].numpy()
    oh = np.lexsort((ph[:, 1], ph[:, 0], key[:n]))
    od = np.lexsort((pd[:, 1], pd[:, 0], key[:n]))
    np.testing.assert_array_equal(ph[oh], pd[od])
    with pytest.raises(ValueError, match="build_scene_host"):
        tnp_prep.build_scene_host(s["points"].astype(np.float64), n,
                                  tc.voxel, 400)


def test_pretrain_step_from_host_scene_equals_step_from_points(nus):
    """One tiny pretrain step on a batch the loader sorted on the host
    (``precompute_scene``) against the same step on its points, from one
    init and one mask: the same losses, gradients and update, bitwise
    (both sorts are stable, so the scenes are equal)."""
    tc = tcfg.tiny_pretrain_config()
    tc = dataclasses.replace(tc, data=dataclasses.replace(
        tc.data, data_root=nus, ann_file="infos.pkl", sweeps_num=2),
        voxel=dataclasses.replace(tc.voxel, point_cloud_range=(
            -20.48, -20.48, -5.0, 20.48, 20.48, 3.0), voxel_size=(
            1.024, 1.024, 8.0)))
    host = tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps,
                                   precompute_scene=True)
    plain = tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps)
    stack = lambda ds: {k: torch.from_numpy(np.stack(
        [ds.__getitem__(i, seed=i)[k] for i in (0, 1)]))
        for k in ds.__getitem__(0, seed=0)}
    hb, pb = stack(host), stack(plain)
    assert hb.keys() > pb.keys() and hb["num_voxels"].min() > 50
    keep = PT.targets_and_mask(tc, pb, torch.Generator().manual_seed(1))[2]
    step = PT.make_train_step(tc)
    out = []
    for batch in (hb, pb):
        state = PT.init_state(tc, "cpu", torch.Generator().manual_seed(0))
        state, losses = step(state, batch, keep=keep)
        grads = {k: p.grad.clone() for k, p in
                 state.model.named_parameters()}
        out.append((losses, grads, state.model.state_dict()))
    (lh, gh, sh), (lp, gp, sp) = out
    for k in lp:
        assert torch.equal(lh[k], lp[k]), k
    for d_h, d_p in ((gh, gp), (sh, sp)):
        for k in d_p:
            assert torch.equal(d_h[k], d_p[k]), k


def test_host_scene_batches_through_loader_shards_and_trainer(nus, tmp_path):
    """Host-sorted samples (``precompute_scene``) keep their int32 and
    bool arrays through the ``PrefetchLoader`` (two ranks' rows stack to
    the whole batch), ``shard_batch``, the trainer's copy to its device,
    and two ``Trainer`` steps of the pretrain step."""
    tc = dataclasses.replace(tcfg.tiny_pretrain_config(), data=dataclasses
                             .replace(tcfg.DataConfig(), data_root=nus,
                                      ann_file="infos.pkl", sweeps_num=2))
    ds = tnus.NuScenesSSLDataset(tc.data, tc.voxel, tc.caps,
                                 precompute_scene=True)
    whole = next(iter(PrefetchLoader(ds, 4, num_workers=0, seed=1)))
    dtypes = {k: v.dtype for k, v in whole.items()}
    assert {dtypes[k] for k in ("p2v", "coords", "slot_low", "slot_med",
                                "slot_sort", "num_voxels")} == {np.dtype(np.int32)}
    assert dtypes["table_valid"] == dtypes["point_valid"] == bool
    for r in (0, 1):
        rows = next(iter(PrefetchLoader(ds, 4, num_workers=2, seed=1,
                                        rank=r, world=2)))
        cut = shard_batch(whole, r, 2)
        for k in whole:
            assert_same(rows[k], cut[k])
            assert_same(rows[k], whole[k][2 * r:2 * r + 2])
    state = PT.init_state(tc, "cpu", torch.Generator().manual_seed(0))
    tr = Trainer(PT.make_train_step(tc), state,
                 PrefetchLoader(ds, 2, num_workers=2), str(tmp_path), 2)
    moved = tr._to_device(whole)
    assert {k: v.numpy().dtype for k, v in moved.items()} == dtypes
    tr.run()
    assert tr.state.step == 2
