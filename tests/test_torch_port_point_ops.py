"""The port's point ops and the last small modules against the JAX package
on the CPU: the PointNet++ op family and k-medoids (indices exactly,
values at 1e-5, on well-separated points of exact distances),
``sample_focal_mask`` on the uniforms JAX draws, the chamfer and axis-aligned IoU losses, the box
helpers, the 3x3 eigen forms, ``box_modes``, ``visualize``'s files byte
for byte, and the ``misc_tools`` sub-commands in process."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pprint
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geomae_tpu_torch.config as tcfg
from geomae_tpu.config import tiny_pretrain_config
from geomae_tpu.core import box_modes as jbm
from geomae_tpu.core import boxes as jboxes
from geomae_tpu.core import visualize as jvis
from geomae_tpu.data import synthetic as jsyn
from geomae_tpu.models import losses as jlosses
from geomae_tpu.models.mae import sample_focal_mask as jax_focal_mask
from geomae_tpu.ops import eig3 as jeig
from geomae_tpu.ops import k_medoids as jkm
from geomae_tpu.ops import pointnet_ops as jpn
from geomae_tpu.ops.voxelize import build_scene_batch as jax_build
from geomae_tpu_torch import misc_tools
from geomae_tpu_torch.apis import init_model
from geomae_tpu_torch.core import box_modes as tbm
from geomae_tpu_torch.core import boxes as tboxes
from geomae_tpu_torch.core import visualize as tvis
from geomae_tpu_torch.models import losses as tlosses
from geomae_tpu_torch.models import mae as tmae
from geomae_tpu_torch.ops import eig3 as teig
from geomae_tpu_torch.ops import k_medoids as tkm
from geomae_tpu_torch.ops import pointnet_ops as tpn
from geomae_tpu_torch.ops.voxelize import VoxelTable
from geomae_tpu_torch.train import finetune as FT
from geomae_tpu_torch.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def same(got: torch.Tensor, want) -> None:
    """Indices or masks: equal values (dtypes may differ)."""
    assert np.array_equal(got.numpy(), np.asarray(want))


def close(got: torch.Tensor, want, tol: float = 1e-5) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _grid_clouds(seed: int):
    """96 source and 24 centre points a batch on the 1/256 m grid of
    [0, 4) m: squared distances are then exact in f32 on both packages
    (their terms are multiples of 2^-16 below 2^8)."""
    rng = np.random.default_rng(seed)
    xyz = rng.integers(0, 1024, (2, 96, 3))
    ctr = rng.integers(0, 1024, (2, 24, 3))
    return xyz, ctr


@pytest.fixture(scope="module")
def clouds():
    """Well-separated clouds: the first seed whose squared distances from
    every centre, and from every source point, are all distinct (so no
    ``topk`` tie is ordered by chance), features of 6 channels, and a
    validity mask."""
    def distinct(a, b):
        d = ((a[:, :, None] - b[:, None]) ** 2).sum(-1)
        return all(len(set(row.tolist())) == len(row)
                   for row in d.reshape(-1, d.shape[-1]))
    seed = next(s for s in range(100) if distinct(*_grid_clouds(s)[::-1])
                and distinct(_grid_clouds(s)[0], _grid_clouds(s)[0]))
    xyz, ctr = (a.astype(np.float32) / 256 for a in _grid_clouds(seed))
    rng = np.random.default_rng(seed + 100)
    feats = rng.normal(size=(2, 6, 96)).astype(np.float32)
    valid = rng.random((2, 96)) < 0.8
    return xyz, ctr, feats, valid


# ---------------------------------------------------------------------------
# the PointNet++ ops and k-medoids
# ---------------------------------------------------------------------------


def test_distances_knn_and_three_nn_match_jax(clouds):
    xyz, ctr, _, valid = clouds
    close(tpn.square_distance(t(ctr), t(xyz), None, t(valid)),
          jpn.square_distance(ctr, xyz, None, valid), 1e-5)
    for k in (1, 5, 16):
        dj, ij = jpn.knn(k, xyz, ctr, xyz_valid=valid)
        dt, it = tpn.knn(k, t(xyz), t(ctr), xyz_valid=t(valid))
        same(it, ij)
        close(dt, dj)
    dj, ij = jpn.knn(4, xyz)                  # the set against itself
    dt, it = tpn.knn(4, t(xyz))
    same(it, ij)
    close(dt, dj)
    dj, ij = jpn.three_nn(ctr, xyz, valid)
    dt, it = tpn.three_nn(t(ctr), t(xyz), t(valid))
    same(it, ij)
    close(dt, dj)


@pytest.mark.parametrize("lo,hi,k", [(0.0, 0.8, 8), (0.3, 1.0, 6),
                                     (0.0, 0.1, 4)])
def test_ball_query_matches_jax(clouds, lo, hi, k):
    """Unused slots repeat slot 0; an empty ball is all index 0 (the last
    case has empty balls)."""
    xyz, ctr, _, valid = clouds
    want = jpn.ball_query(lo, hi, k, xyz, ctr, xyz_valid=valid)
    got = tpn.ball_query(lo, hi, k, t(xyz), t(ctr), xyz_valid=t(valid))
    assert got.dtype == torch.int32
    same(got, want)


def test_furthest_point_sampling_matches_jax(clouds):
    xyz, _, _, valid = clouds
    same(tpn.furthest_point_sample(t(xyz), 20),
         jpn.furthest_point_sample(xyz, 20))
    got = tpn.furthest_point_sample(t(xyz), 20, t(valid))
    same(got, jpn.furthest_point_sample(xyz, 20, valid))
    assert np.take_along_axis(valid, got.long().numpy(), 1)[:, 1:].all()
    d = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    same(tpn.furthest_point_sample_with_dist(t(d), 20),
         jpn.furthest_point_sample_with_dist(d, 20))


def test_gather_group_interpolate_match_jax(clouds):
    """Values at 1e-5 and gradients through autograd, as JAX's
    autodiff."""
    xyz, ctr, feats, valid = clouds
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 96, (2, 24)).astype(np.int32)
    close(tpn.gather_points(t(feats), t(idx)), jpn.gather_points(feats, idx))
    gidx = rng.integers(0, 96, (2, 24, 5)).astype(np.int32)
    close(tpn.group_points(t(feats), t(gidx)),
          jpn.group_points(feats, gidx))
    _, nn3 = jpn.three_nn(ctr, xyz)
    w = rng.uniform(0, 1, (2, 24, 3)).astype(np.float32)
    f = t(feats).requires_grad_()
    out = tpn.three_interpolate(f, t(nn3), t(w))
    close(out, jpn.three_interpolate(feats, nn3, w))
    g = rng.normal(size=out.shape).astype(np.float32)
    out.backward(t(g))
    want = jax.grad(lambda a: (jpn.three_interpolate(a, nn3, w) * g).sum())(
        jnp.asarray(feats))
    close(f.grad, want)
    for kw in (dict(max_radius=0.8, sample_num=8),
               dict(max_radius=0.8, sample_num=8, normalize_xyz=True),
               dict(max_radius=None, sample_num=6),
               dict(max_radius=0.8, sample_num=8, use_xyz=False)):
        close(tpn.query_and_group(t(xyz), t(ctr), t(feats), **kw),
              jpn.query_and_group(xyz, ctr, feats, **kw))
    close(tpn.query_and_group(t(xyz), t(ctr), max_radius=0.8),
          jpn.query_and_group(xyz, ctr, max_radius=0.8))
    close(tpn.group_all(t(xyz), t(feats)), jpn.group_all(xyz, feats))
    close(tpn.group_all(t(xyz)), jpn.group_all(xyz))


def test_k_medoids_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(3, 40, 3))
    d = np.linalg.norm(pts[:, :, None] - pts[:, None], axis=-1)
    d = d.astype(np.float32)
    same(tkm.select_initial_medoids(t(d), 6),
         jkm.select_initial_medoids(d, 6))
    med = jkm.select_initial_medoids(d, 6)
    asg, tot = jkm.assign_samples_to_medoids(d, med)
    got_asg, got_tot = tkm.assign_samples_to_medoids(t(d), t(med))
    same(got_asg, asg)
    close(got_tot, tot)
    same(tkm.update_medoids(t(d), t(asg), 6), jkm.update_medoids(d, asg, 6))
    for iters in (0, 1, 3):
        same(tkm.k_medoids(t(d), 6, max_iter=iters),
             jkm.k_medoids(d, 6, max_iter=iters))
    same(tkm.k_medoids(t(d[:, :4, :4]), 6, padding_idx=7),
         jkm.k_medoids(d[:, :4, :4], 6, padding_idx=7))


# ---------------------------------------------------------------------------
# masks, losses, boxes, eigen forms
# ---------------------------------------------------------------------------


def test_focal_mask_on_jax_uniforms():
    """The port's choice of kept foreground pillars on the uniforms the
    JAX function draws (``jax.random.split`` of the key, one ``uniform``
    a sample) gives JAX's keep mask exactly; the port's own draw keeps
    the background and the same share of the foreground."""
    cfg = tiny_pretrain_config()
    B, P = 2, cfg.caps.max_points
    r = cfg.voxel.point_cloud_range
    rng = np.random.default_rng(4)
    pts = rng.uniform([r[0], r[1], -2], [r[3], r[4], 0],
                      (B, P, 3)).astype(np.float32)
    scene = jax.jit(jax_build, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.ones((B, P), bool), cfg.voxel, 2048)
    boxes = np.zeros((B, 4, 9), np.float32)
    boxes[:, :, :7] = [[2.5, 2.5, -2, 5, 5, 4, 0.3], [-5, -3, 0, 4, 3, 1, 1],
                       [6, -6, 0, 3, 3, 2, -0.4], [0, 0, 0, 50, 50, 9, 0]]
    gmask = np.array([[1, 1, 0, 0], [1, 1, 1, 0]], bool)
    key = jax.random.PRNGKey(3)
    want = jax.jit(jax_focal_mask, static_argnums=(4, 5))(
        key, scene.table, boxes, gmask, cfg.voxel, 0.7)
    table = VoxelTable(*map(t, scene.table))
    fg = tmae.focal_foreground(table, t(boxes), t(gmask), cfg.voxel)
    V = fg.shape[1]
    u = np.stack([np.asarray(jax.random.uniform(k, (V,)))
                  for k in jax.random.split(key, B)])
    got = tmae.focal_keep(fg, table.valid, t(u), 0.7)
    same(got, want)
    assert 0 < int(fg.sum()) < int(table.valid.sum())
    own = tmae.sample_focal_mask(torch.Generator().manual_seed(0), table,
                                 t(boxes), t(gmask), cfg.voxel, 0.7)
    bg = table.valid & ~fg
    assert bool(own[bg].all()) and not bool(own[~table.valid].any())
    assert torch.equal(own.sum(1), got.sum(1))


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(30, 3)).astype(np.float32)
    b = rng.normal(size=(20, 3)).astype(np.float32)
    va, vb = rng.random(30) < 0.7, rng.random(20) < 0.6
    for m in ((None, None), (va, vb), (va, None)):
        got = tlosses.chamfer_distance(t(a), t(b), *(
            None if x is None else t(x) for x in m))
        want = jlosses.chamfer_distance(a, b, *m)
        for g, w in zip(got, want):
            close(g, w)
    lo = rng.uniform(-2, 0, (50, 3))
    p = np.concatenate([lo, lo + rng.uniform(0.1, 3, (50, 3))], -1)
    q = p + rng.normal(0, 0.5, p.shape)
    p, q = p.astype(np.float32), q.astype(np.float32)
    got = tlosses.axis_aligned_iou_loss(t(p), t(q))
    close(got, jlosses.axis_aligned_iou_loss(p, q))
    assert float(got.min()) < 1 and float(
        tlosses.axis_aligned_iou_loss(t(p), t(p)).abs().max()) < 1e-6


def test_box_helpers_and_eig_forms_match_jax():
    rng = np.random.default_rng(6)
    boxes = np.concatenate([rng.uniform(-5, 5, (7, 3)),
                            rng.uniform(0.5, 3, (7, 3)),
                            rng.uniform(-3, 3, (7, 1))], -1).astype(np.float32)
    pts = rng.uniform(-6, 6, (300, 3)).astype(np.float32)
    close(tboxes.gravity_center(t(boxes)), jboxes.gravity_center(boxes))
    got = tboxes.points_in_boxes(t(pts), t(boxes))
    same(got, jboxes.points_in_boxes(pts, boxes))
    assert 0 < int(got.sum()) < got.numel()
    # batched: [B, P, 3] x [B, N, 7]
    same(tboxes.points_in_boxes(t(pts[None]), t(boxes[None]))[0], got)
    X = rng.normal(size=(50, 10, 3))
    cov = np.einsum("npi,npj->nij", X, X).astype(np.float32) / 10
    ev = teig.eigvals3x3_sym(t(cov))
    close(ev, jeig.eigvals3x3_sym(cov), 1e-4)
    close(teig.smallest_eigvec3x3_sym(t(cov), ev[..., 2]),
          jeig.smallest_eigvec3x3_sym(cov, jnp.asarray(ev[..., 2].numpy())),
          1e-4)
    for g, w in zip(teig.normal_and_curvature(t(cov)),
                    jeig.normal_and_curvature(cov)):
        close(g, w, 1e-4)


def test_box_modes_match_jax():
    rng = np.random.default_rng(7)
    boxes = np.concatenate([rng.normal(0, 10, (20, 3)),
                            rng.uniform(0.5, 4.0, (20, 3)),
                            rng.uniform(-np.pi, np.pi, (20, 1)),
                            rng.normal(0, 2, (20, 2))], -1)
    rt = np.eye(4)
    rt[:3, 3] = [1.0, 2.0, 3.0]
    modes = list(tbm.Box3DMode)
    for a in modes:
        for b in modes:
            for m in (None, rt, rt[:3, :3]):
                if a != b or m is None:
                    got = tbm.convert(boxes, a, b, m)
                    assert np.array_equal(got, jbm.convert(
                        boxes, jbm.Box3DMode(int(a)), jbm.Box3DMode(int(b)),
                        m))
            np.testing.assert_allclose(
                tbm.convert(tbm.convert(boxes, a, b), b, a), boxes,
                atol=1e-12)


def test_visualize_files_byte_equal(tmp_path):
    rng = np.random.default_rng(8)
    pts = rng.normal(0, 5, (100, 4)).astype(np.float32)
    pred = np.array([[0, 0, -1, 4, 2, 1.5, 0.3, 0, 0],
                     [5, 1, -1, 1, 1, 1.7, -1.0, 0, 0]], np.float32)
    gt = pred[:1] + 0.5
    out = {}
    for name, mod in (("j", jvis), ("t", tvis)):
        out[name] = mod.show_result(pts, gt, pred, str(tmp_path / name),
                                    "frame0", scores=np.array([0.9, 0.4]),
                                    bev_png=False)
    assert set(out["t"]) == {"points", "gt", "pred"}
    for k in out["t"]:
        with open(out["t"][k], "rb") as a, open(out["j"][k], "rb") as b:
            assert a.read() == b.read(), k
    np.testing.assert_array_equal(tvis.box_corners(pred),
                                  jvis.box_corners(pred))
    dets = SimpleNamespace(boxes=torch.from_numpy(pred[None]),
                           scores=torch.tensor([[0.9, 0.2]]),
                           valid=torch.tensor([[True, True]]))
    got = tvis.show_results_batch(dets, str(tmp_path / "b"), ["f"],
                                  points_batch=torch.from_numpy(pts[None]))
    assert set(got[0]) >= {"points", "pred"}
    with open(got[0]["pred"]) as f:
        assert sum(line.startswith("v ") for line in f) == 8


# ---------------------------------------------------------------------------
# misc_tools
# ---------------------------------------------------------------------------


def run(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        misc_tools.main(argv)
    return buf.getvalue()


def jax_tools():
    """The JAX package's ``tools/misc_tools.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_misc_tools", os.path.join(REPO, "tools", "misc_tools.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_misc_tools_print_config_and_analyze_logs(tmp_path):
    out = run(["print_config", "tiny_finetune"])
    assert out == pprint.pformat(
        dataclasses.asdict(tcfg.tiny_finetune_config())) + "\n"
    log = tmp_path / "metrics.jsonl"
    rows = [dict(mode="train", step=i, loss=2.0 - 0.1 * i, loss_cls=1.0 / (
        i + 1), iter_time=0.5 + 0.01 * i) for i in range(5)]
    log.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    got = run(["analyze_logs", "--log", str(log)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_tools().analyze_logs(SimpleNamespace(log=str(log)))
    assert got == buf.getvalue() and "loss_cls" in got


def test_misc_tools_publish_and_visualize(tmp_path):
    """A trainer checkpoint stripped to weights that ``init_model`` loads
    strictly, then served and drawn by ``visualize_results``."""
    cfg = tcfg.tiny_finetune_config()
    state = FT.init_state(cfg, "cpu", torch.Generator().manual_seed(1))
    state.step = 3
    CheckpointManager(str(tmp_path / "ckpt")).save(state, force=True)
    out = str(tmp_path / "w.pth")
    run(["publish_model", "--ckpt-dir", str(tmp_path / "ckpt"), "--out",
         out, "--task", "finetune", "--tiny"])
    obj = torch.load(out, weights_only=True)
    assert set(obj) == {"state_dict"}
    det = init_model(out, cfg, device="cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(det.model.state_dict()[k], v), k
    text = run(["visualize_results", "--ckpt-dir", out, "--tiny",
                "--device", "cpu", "-n", "1", "--score-thr", "0",
                "--out-dir", str(tmp_path / "viz")])
    assert text.startswith("frame0000: ")
    with open(tmp_path / "viz" / "frame0000" / "frame0000_points.obj") as f:
        assert sum(1 for _ in f) == cfg.caps.max_points


def test_misc_tools_browse_dataset(tmp_path):
    """One line a frame, as the JAX tool prints for the same files."""
    root = str(tmp_path / "nus")
    jsyn.write_synthetic_infos(root, n_frames=2, n_points=3000, n_sweeps=2)
    got = run(["browse_dataset", "--data-root", root, "--ann-file",
               "infos.pkl", "-n", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_tools().browse_dataset(SimpleNamespace(
            data_root=root, ann_file="infos.pkl", n=2))
    assert got == buf.getvalue() and got.count("frame ") == 2
