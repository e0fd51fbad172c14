"""The port's serving slice against the JAX package at tiny width, f32, on
the CPU (plain versions of the kernels): window layouts, the VFE, the SST
stack, the whole DynamicVoxelNet's head outputs and ``predict``'s
detections, all from the same weights (``from_flax``) and inputs."""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.config import tiny_finetune_config
from geomae_tpu.models.detector import DynamicVoxelNet as JaxNet
from geomae_tpu.models.sst import SSTStack as JaxSST
from geomae_tpu.models.sst import prepare_shift_data as jax_shift_data
from geomae_tpu.models.vfe import DynamicScatterVFE as JaxVFE
from geomae_tpu.ops import windows as jwin
from geomae_tpu.ops.voxelize import build_scene_batch as jax_build
from geomae_tpu.train import finetune as FT
from geomae_tpu_torch.apis import Detector3D, init_model, inference_detector
from geomae_tpu_torch.models.anchor_head import predict
from geomae_tpu_torch.models.anchors import grid_anchors, head_featmap_size
from geomae_tpu_torch.models.detector import DynamicVoxelNet, extract_scene
from geomae_tpu_torch.models.sst import prepare_shift_data
from geomae_tpu_torch.ops import voxelize, windows
from geomae_tpu_torch.weights import from_flax
from test_torch_port_weights import randomized_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2


def spread_points(rng, cfg, n_pillars=200, per_pillar=8):
    """Points in ``n_pillars`` pillars spread over the whole grid (under
    the row cap), so every head cell sees distinct features and the
    detection scores have no ties."""
    vx, vy, _ = cfg.voxel.voxel_size
    r = cfg.voxel.point_cloud_range
    ny, nx = cfg.voxel.grid_size
    P = cfg.caps.max_points
    pts = np.zeros((B, P, 5), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        cells = rng.choice(ny * nx, n_pillars, replace=False)
        cy, cx = cells // nx, cells % nx
        n = n_pillars * per_pillar
        xyz = np.stack([
            r[0] + (np.repeat(cx, per_pillar) + rng.uniform(0.05, 0.95, n)) * vx,
            r[1] + (np.repeat(cy, per_pillar) + rng.uniform(0.05, 0.95, n)) * vy,
            rng.uniform(-2.0, 0.5, n)], -1)
        pts[b, :n, :3] = xyz
        pts[b, :n, 3:] = rng.uniform(0, 0.5, (n, 2))
        valid[b, :n] = True
    return pts, valid


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_finetune_config()
    params, stats = randomized_state(cfg)
    model = DynamicVoxelNet(cfg)
    model.load_state_dict(from_flax(params, stats), strict=True)
    model.eval()
    pts, valid = spread_points(np.random.default_rng(0), cfg)
    js = jax_build(jnp.asarray(pts), jnp.asarray(valid), cfg.voxel,
                   cfg.caps.max_voxels)
    return SimpleNamespace(cfg=cfg, params=params, stats=stats, model=model,
                           pts=pts, valid=valid, js=js)


def to_port(js) -> voxelize.Scene:
    """The JAX scene's arrays as the port's Scene (same row order)."""
    t = lambda a: torch.from_numpy(np.array(a))
    return voxelize.Scene(
        points=t(js.points), valid=t(js.valid),
        table=voxelize.VoxelTable(*map(t, js.table)),
        slot_low=t(js.slot_low), slot_med=t(js.slot_med),
        slot_sort=t(js.slot_sort))


def test_layouts_and_pos_embedding_match_jax(tiny):
    cfg, js = tiny.cfg, tiny.js
    coords, valid = js.table.coords, js.table.valid
    jl = jwin.make_layouts(coords, valid, cfg.sst, cfg.voxel)
    tl = windows.make_layouts(torch.from_numpy(np.array(coords)),
                              torch.from_numpy(np.array(valid)), cfg.sst,
                              cfg.voxel)
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a.win_id), b.win_id.numpy())
        assert np.array_equal(np.asarray(a.coors_in_win),
                              b.coors_in_win.numpy())
        iota = torch.arange(b.perm.shape[1]).expand_as(b.perm)
        assert torch.equal(torch.gather(b.inv_perm, 1, b.perm), iota)
        pos_j = jwin.positional_embedding(a.coors_in_win, cfg.sst)
        pos_t = windows.positional_embedding(b.coors_in_win, cfg.sst)
        np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j),
                                   rtol=1e-6, atol=1e-6)
    # the sorted ids are the row ids gathered through perm
    w0, _ = windows.window_ids(torch.from_numpy(np.array(coords)),
                               torch.from_numpy(np.array(valid)),
                               cfg.sst.shifts[0], cfg.sst, cfg.voxel)
    assert torch.equal(torch.gather(w0, 1, tl[0].perm), tl[0].win_id)


def test_vfe_matches_jax(tiny):
    """Tolerance 1e-5: Linear/BN over 11 and 32 channels in f32."""
    got = tiny.model.voxel_encoder(to_port(tiny.js), torch.float32).detach()
    vfe = JaxVFE(tiny.cfg.vfe, tiny.cfg.voxel, jnp.float32)
    want = jax.jit(lambda v, scene: vfe.apply(v, scene, False))(
        {"params": tiny.params["voxel_encoder"],
         "batch_stats": tiny.stats["voxel_encoder"]}, tiny.js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 1.0


def test_sst_stack_matches_jax(tiny):
    """Tolerance 1e-4: four post-norm encoder layers in f32, sums over 32
    channels and windows of up to 144 tokens in other orders."""
    cfg, js = tiny.cfg, tiny.js
    feats = np.random.default_rng(1).normal(
        0, 0.5, (B, cfg.caps.max_voxels, cfg.sst.d_model)).astype(np.float32)
    coords, valid = js.table.coords, js.table.valid
    shift = jax_shift_data(jwin.make_layouts(coords, valid, cfg.sst,
                                             cfg.voxel),
                           None, valid, cfg.sst, cfg.voxel)
    sst = JaxSST(cfg.sst, cfg.num_blocks, jnp.float32)
    want = jax.jit(sst.apply)({"params": tiny.params["encoder"]},
                              jnp.asarray(feats), shift)
    tc, tv = (torch.from_numpy(np.array(a)) for a in (coords, valid))
    tshift = prepare_shift_data(
        windows.make_layouts(tc, tv, cfg.sst, cfg.voxel), tv, cfg.sst)
    got = tiny.model.backbone.encoder_blocks(torch.from_numpy(feats),
                                             tshift).detach().numpy()
    v = np.asarray(valid)
    np.testing.assert_allclose(got[v], np.asarray(want)[v], rtol=1e-4,
                               atol=1e-4)


def jax_outputs(tiny):
    scene = FT.extract_scene(tiny.cfg, jnp.asarray(tiny.pts),
                             jnp.asarray(tiny.valid))
    net = JaxNet(tiny.cfg)
    return jax.jit(lambda v, sc: net.apply(v, sc, train=False))(
        {"params": tiny.params, "batch_stats": tiny.stats}, scene)


def port_outputs(tiny):
    scene = extract_scene(tiny.cfg, torch.from_numpy(tiny.pts),
                          torch.from_numpy(tiny.valid))
    with torch.no_grad():
        return tiny.model(scene)


def test_head_outputs_match_jax(tiny):
    """The whole model, voxelization included; 3e-4 abs as the JAX
    package's own full-model parity (tests/test_torch_full_model.py)."""
    want, got = jax_outputs(tiny), port_outputs(tiny)
    for name in ("cls", "reg", "dir"):
        w = np.moveaxis(np.asarray(getattr(want, name)), -1, 1)
        np.testing.assert_allclose(getattr(got, name).numpy(), w, atol=3e-4,
                                   rtol=1e-4)


def test_predict_matches_jax(tiny):
    """Detections as matched sets: same (label, score) multiset, boxes at
    1e-4.  ``lax.top_k`` and ``torch.topk`` order ties differently; the
    case has no tie at the ``nms_pre`` cut, so both keep the same
    candidates."""
    cfg = tiny.cfg
    fn = FT.make_predict_fn(cfg)
    want = jax.jit(lambda p, s, b: fn(
        SimpleNamespace(params=p, batch_stats=s), b))(
        tiny.params, tiny.stats, dict(points=jnp.asarray(tiny.pts),
                                      point_valid=jnp.asarray(tiny.valid)))
    out = port_outputs(tiny)
    anchors = torch.from_numpy(grid_anchors(cfg.head, head_featmap_size(cfg)))
    got = predict(out, anchors, cfg.head)
    for b in range(B):
        best = np.sort(torch.sigmoid(out.cls[b]).amax(0).numpy().ravel())
        k = cfg.head.nms_pre
        assert best[-k] != best[-k - 1]      # no tie at the top-k cut
        wv = np.asarray(want.valid[b])
        gv = got.valid[b].numpy()
        assert 0 < wv.sum() == gv.sum()
        wl, ws = np.asarray(want.labels[b])[wv], np.asarray(want.scores[b])[wv]
        gl, gs = got.labels[b].numpy()[gv], got.scores[b].numpy()[gv]
        wi, gi = np.lexsort((-ws, wl)), np.lexsort((-gs, gl))
        assert np.array_equal(wl[wi], gl[gi])
        np.testing.assert_allclose(gs[gi], ws[wi], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.boxes[b].numpy()[gv][gi],
                                   np.asarray(want.boxes[b])[wv][wi],
                                   rtol=1e-4, atol=1e-4)


def test_detector3d_serves_and_loads_checkpoints(tiny, tmp_path):
    """Seeded init is deterministic; a saved state_dict loads strictly
    and serves the same detections."""
    cfg = tiny.cfg
    a = Detector3D(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    b = Detector3D(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    path = tmp_path / "det.pth"
    torch.save({"state_dict": tiny.model.state_dict()}, path)
    c = init_model(str(path), cfg, device="cpu")
    raw = tiny.pts[0][tiny.valid[0]]
    res = inference_detector(c, raw)
    n = len(res["scores"])
    assert n > 0 and res["boxes"].shape == (n, 9)
    assert np.isfinite(res["boxes"]).all()
    assert ((res["labels"] >= 0) & (res["labels"] < 10)).all()
    out = port_outputs(tiny)
    det = predict(type(out)(*[t[:1] for t in out]), c.anchors, cfg.head)
    m = det.valid[0].numpy()
    np.testing.assert_allclose(np.sort(res["scores"]),
                               np.sort(det.scores[0].numpy()[m]), rtol=1e-5)


def test_serving_api_imports_no_jax():
    code = ("import sys, geomae_tpu_torch.apis; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', "
            "'geomae_tpu') or m.startswith(('jax.', 'flax.', "
            "'geomae_tpu.'))]; "
            "sys.exit(str(bad) if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
