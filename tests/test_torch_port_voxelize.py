"""geomae_tpu_torch.ops.voxelize against geomae_tpu.ops.voxelize: the
pillar table and the slots agree bitwise; the sorted points agree per
(pillar, slot) group, because the JAX sort (``lax.sort_key_val``) leaves
the order inside equal keys open while the port's sort is stable."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.config import tiny_finetune_config
from geomae_tpu.ops.voxelize import build_scene_batch as jax_build
from geomae_tpu_torch.ops.voxelize import build_scene_batch, low_voxel_coords


def clustered_points(rng, voxel, B, P):
    """Clustered clouds with a padded suffix; coordinates also land on
    exact pillar boundaries and outside the grid (clamped)."""
    r = voxel.point_cloud_range
    pts = np.zeros((B, P, 5), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        n = int(rng.integers(P // 2, P))
        centers = rng.uniform([r[0], r[1], -2.0], [r[3], r[4], 0.5], (20, 3))
        xyz = centers[rng.integers(0, 20, n)] + rng.normal(0, 0.4, (n, 3))
        xyz[: n // 10, :2] = np.round(xyz[: n // 10, :2] * 4) / 4
        pts[b, :n, :3] = xyz
        pts[b, :n, 3:] = rng.uniform(0, 1, (n, 2))
        valid[b, :n] = True
    return pts, valid


def group_sorted(points, slot_sort, p2v, voxel):
    """Valid points ordered by (pillar key, slot, values): positions of one
    (pillar, slot) group are contiguous in both scenes, so sorting inside
    the groups makes the two orders comparable."""
    low = low_voxel_coords(torch.from_numpy(points[:, :3]), voxel).numpy()
    _, ry, rx = voxel.sub_voxel_ratio_low
    key = (low[:, 1] // ry) * voxel.grid_size[1] + low[:, 2] // rx
    order = np.lexsort(tuple(points.T[::-1]) + (slot_sort, key))
    return points[order], p2v[order]


@pytest.mark.parametrize("v_cap,overflows", [(1024, False), (48, True)])
def test_scene_matches_jax(v_cap, overflows):
    """With v_cap 48 the pillars overflow: points of pillars past the cap
    carry ``v_cap``."""
    cfg = tiny_finetune_config()
    rng = np.random.default_rng(0)
    pts, valid = clustered_points(rng, cfg.voxel, 2, cfg.caps.max_points)
    js = jax_build(jnp.asarray(pts), jnp.asarray(valid), cfg.voxel, v_cap)
    ts = build_scene_batch(torch.from_numpy(pts), torch.from_numpy(valid),
                           cfg.voxel, v_cap)
    for name in ("coords", "valid", "num_voxels", "point2voxel"):
        a = np.asarray(getattr(js.table, name))
        b = getattr(ts.table, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("valid", "slot_low", "slot_med", "slot_sort"):
        assert np.array_equal(np.asarray(getattr(js, name)),
                              getattr(ts, name).numpy()), name
    nv = np.asarray(js.table.num_voxels)
    assert (nv > v_cap).any() == overflows
    jp = np.asarray(js.points)
    for b in range(2):
        m = np.asarray(js.valid[b])
        sl = np.asarray(js.slot_sort[b])[m]
        p2v = np.asarray(js.table.point2voxel[b])[m]
        a = group_sorted(jp[b][m], sl, p2v, cfg.voxel)
        c = group_sorted(ts.points[b].numpy()[m], sl, p2v, cfg.voxel)
        assert np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1])
        assert not ts.points[b].numpy()[~m].any()
