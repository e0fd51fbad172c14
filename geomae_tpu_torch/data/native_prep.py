"""Native sample preparation (the SSL pretrain path).

The port's copy of ``geomae_tpu/data/native_prep.py``: multi-sweep merge
+ augmentation + range filter + padding as one C++ pass per sweep
(``csrc/pointprep.cpp``, built by ``data/_native.py``), writing straight
into the padded output buffer, and the scene's sort on the host
(``build_scene_host``).  Both sample the same augmentation parameters as
the numpy pipeline of ``data/nuscenes.py`` and agree with it point for
point, up to float rounding and point order.

Unlike the JAX package, which falls back to numpy when the library is
missing, these functions use the library or raise: the numpy pipeline
is the caller's explicit choice (``NuScenesSSLDataset(native=False)``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from ..config import CapsConfig, DataConfig, VoxelConfig
from . import _native
from .pointcloud import _abspath, load_points_bin


def sample_aug_params(cfg: DataConfig, rng: np.random.Generator,
                      train: bool) -> Dict:
    if not train:
        return dict(rot=0.0, scale=1.0, flip_y=False, flip_x=False)
    return dict(
        rot=float(rng.uniform(*cfg.rot_range)),
        scale=float(rng.uniform(*cfg.scale_range)),
        flip_y=bool(rng.random() < cfg.flip_ratio_horizontal),
        flip_x=bool(rng.random() < cfg.flip_ratio_vertical),
    )


def prepare_ssl_sample(info: Dict, cfg: DataConfig, voxel: VoxelConfig,
                       caps: CapsConfig, rng: np.random.Generator,
                       train: bool = True) -> Dict:
    """``dict(points [P, D], point_valid [P])`` of one nuScenes info."""
    lib = _native.library()
    aug = sample_aug_params(cfg, rng, train)
    pcr = np.asarray(voxel.point_cloud_range, np.float32)
    out = np.zeros((caps.max_points, cfg.use_dim), np.float32)
    cursor = ctypes.c_int64(0)

    def run(pts, R, t, lag):
        _native.prep_sweep(
            np.ascontiguousarray(pts[:, :cfg.use_dim]), out, cursor,
            R, t, lag, cfg.remove_close_radius,
            aug["rot"], aug["scale"], aug["flip_y"], aug["flip_x"], pcr)

    key = load_points_bin(_abspath(info["lidar_path"], cfg.data_root),
                          cfg.load_dim, cfg.use_dim)
    run(key, None, None, 0.0)
    ts = info["timestamp"] / 1e6
    sweeps = info.get("sweeps", [])[: cfg.sweeps_num]
    for sw in sweeps:
        pts = load_points_bin(_abspath(sw["data_path"], cfg.data_root),
                              cfg.load_dim, cfg.use_dim)
        R = np.ascontiguousarray(
            np.asarray(sw["sensor2lidar_rotation"], np.float32))
        t = np.ascontiguousarray(
            np.asarray(sw["sensor2lidar_translation"], np.float32))
        run(pts, R, t, float(ts - sw["timestamp"] / 1e6))

    n = cursor.value
    if train and cfg.shuffle_points and n > 1:
        lib.shuffle_rows(_native.f32_ptr(out), n, out.shape[1],
                         int(rng.integers(1, 2**63)))
    valid = np.zeros(caps.max_points, bool)
    valid[:n] = True
    return dict(points=out, point_valid=valid)


def build_scene_host(points: np.ndarray, n_valid: int, voxel: VoxelConfig,
                     v_cap: int) -> Dict:
    """The canonical scene of ``points`` [P, D] (float32, C order; its
    first ``n_valid`` rows valid) sorted on the host by a C++ radix sort,
    the loader-side counterpart of ``ops.voxelize.build_scene_batch``:
    a dict of the :class:`geomae_tpu_torch.ops.voxelize.Scene` fields'
    arrays for one sample (``ops.voxelize.scene_from_arrays`` takes the
    stacked batch)."""
    if points.dtype != np.float32 or not points.flags.c_contiguous \
            or not 0 <= n_valid <= len(points):
        raise ValueError(f"build_scene_host: points {points.dtype} "
                         f"{points.shape}, {n_valid} valid")
    ny, nx = voxel.grid_size
    if ny * nx * voxel.num_slots_low > 2**26:
        # the C++ radix sort orders 26 bits of (pillar, slot) key
        raise ValueError(f"build_scene_host: a {ny} x {nx} grid of "
                         f"{voxel.num_slots_low} slots exceeds 2^26 keys")
    lib = _native.library()
    P, D = points.shape
    r = voxel.point_cloud_range
    rz, ry, rx = voxel.sub_voxel_ratio_low
    mz, my, mx = voxel.sub_voxel_ratio_med
    vx, vy, vz = voxel.voxel_size
    out_pts = np.zeros_like(points)
    slot_low = np.zeros(P, np.int32)
    slot_med = np.zeros(P, np.int32)
    slot_sort = np.zeros(P, np.int32)
    p2v = np.zeros(P, np.int32)
    coords = np.zeros((v_cap, 2), np.int32)
    tvalid = np.zeros(v_cap, np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nv = lib.build_scene(
        _native.f32_ptr(points), n_valid, D,
        np.float32(r[0]), np.float32(r[1]), np.float32(r[2]),
        np.float32(vx / rx), np.float32(vy / ry), np.float32(vz / rz),
        nx, ny, rx, ry, rz, mx, my, mz, P, v_cap,
        _native.f32_ptr(out_pts),
        slot_low.ctypes.data_as(i32p), slot_med.ctypes.data_as(i32p),
        slot_sort.ctypes.data_as(i32p),
        p2v.ctypes.data_as(i32p), coords.ctypes.data_as(i32p),
        tvalid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    valid = np.zeros(P, bool)
    valid[:n_valid] = True
    return dict(points=out_pts, point_valid=valid,
                slot_low=slot_low, slot_med=slot_med, slot_sort=slot_sort,
                p2v=p2v, coords=coords, table_valid=tvalid.astype(bool),
                num_voxels=np.int32(min(nv, 2**31 - 1)))
