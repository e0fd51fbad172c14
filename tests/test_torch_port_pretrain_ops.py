"""The pretrain step's parts in the port against the JAX package, f32, on
the CPU (plain versions of the kernels): K3 and K4 against the Pallas
kernels in interpret mode, the eigensolver, the geometric targets against
both JAX routes, the mask and its compaction, the batched injective
gather, the decoder pair, GeoMAE's predictions and ``pretrain_loss``, all
at ``tiny_pretrain_config()`` from the same weights (``from_flax``) and
inputs; plus the port's own config presets and the GeoMAE state_dict
against the reference checkpoint's names."""
import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import geomae_tpu.config as jcfg
import geomae_tpu_torch.config as tcfg
from geomae_tpu.models import mae as jmae
from geomae_tpu.models.sst import SSTStackPair as JaxPair
from geomae_tpu.models.sst import prepare_shift_data as jax_shift_data
from geomae_tpu.ops import eig3 as jeig3
from geomae_tpu.ops import pallas_segreduce as jseg
from geomae_tpu.ops import pallas_segreduce_t as jseg_t
from geomae_tpu.ops import scatter as jscatter
from geomae_tpu.ops import windows as jwin
from geomae_tpu.ops.voxelize import build_scene_batch as jax_build
from geomae_tpu.train import pretrain as JPT
from geomae_tpu.train.torch_import import import_torch_weights
from geomae_tpu_torch.models import mae
from geomae_tpu_torch.models.sst import prepare_shift_data
from geomae_tpu_torch.ops import eig3, scatter, targets, voxelize, windows
from geomae_tpu_torch.synthetic import clustered_frame
from geomae_tpu_torch.weights import from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2


def randomized_geomae(cfg, seed=0):
    """GeoMAE params and batch_stats of the JAX package, every leaf
    perturbed from its init so that no two agree by accident: kernels keep
    their init, every other leaf moves by N(0, 0.1), BN variances to 1 +
    |N(0, 0.2)|."""
    state, _ = JPT.init_state(cfg, 1, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "kernel":
            return a
        if name == "var":
            return (1 + np.abs(rng.normal(0, 0.2, a.shape))).astype(np.float32)
        return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(perturb, state.params),
            jax.tree_util.tree_map_with_path(perturb, state.batch_stats))


def frames(cfg, seed):
    """B clustered frames padded to the point cap (about 1,500 points in
    over 256 pillars: the cap overflows, as at full width)."""
    rng = np.random.default_rng(seed)
    P = cfg.caps.max_points
    pts = np.zeros((B, P, 5), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        f = clustered_frame(rng, cfg.voxel, P, n_clusters=12)
        pts[b, :len(f)], valid[b, :len(f)] = f, True
    return pts, valid


def to_port(js) -> voxelize.Scene:
    """The JAX scene's arrays as the port's Scene (same point order)."""
    t = lambda a: torch.from_numpy(np.array(a))
    return voxelize.Scene(
        points=t(js.points), valid=t(js.valid),
        table=voxelize.VoxelTable(*map(t, js.table)),
        slot_low=t(js.slot_low), slot_med=t(js.slot_med),
        slot_sort=t(js.slot_sort))


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jcfg.tiny_pretrain_config(), tcfg.tiny_pretrain_config()
    pts, valid = frames(tc, 0)
    js = jax_build(jnp.asarray(pts), jnp.asarray(valid), jc.voxel,
                   jc.caps.max_voxels)
    keep = jmae.sample_mask(jax.random.PRNGKey(4), js.table.valid,
                            jc.mae.random_mask_ratio)
    params, stats = randomized_geomae(jc)
    return SimpleNamespace(jc=jc, tc=tc, pts=pts, valid=valid, js=js,
                           ts=to_port(js), keep=keep,
                           tkeep=torch.from_numpy(np.array(keep)),
                           params=params, stats=stats)


def port_model(tiny):
    model = mae.GeoMAE(tiny.tc)
    model.load_state_dict(from_flax(tiny.params, tiny.stats), strict=True)
    return model


def test_config_presets_match_jax():
    """Every preset of the port's config equals its JAX twin, field by
    field, and ``replace`` works alike."""
    names = [n for n in dir(jcfg) if n.startswith(("geomae_", "tiny_"))]
    assert len(names) >= 7
    for n in names:
        a, b = getattr(jcfg, n)(), getattr(tcfg, n)()
        assert type(a).__name__ == type(b).__name__, n
        assert dataclasses.asdict(a) == dataclasses.asdict(b), n
    a = jcfg.replace(jcfg.geomae_pretrain_nus(), compute_dtype="float32")
    b = tcfg.replace(tcfg.geomae_pretrain_nus(), compute_dtype="float32")
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tcfg.geomae_pretrain_nus().voxel.grid_size == (400, 400)


def slot_case(rng, B_=2, P=512, V=30, S=128, cv=4):
    """Ascending pillar ids with empty rows and a zeroed sentinel suffix."""
    seg = np.sort(rng.integers(0, V - 3, (B_, P)), axis=1).astype(np.int32)
    slot = rng.integers(0, S, (B_, P)).astype(np.int32)
    vals = rng.normal(size=(B_, P, cv)).astype(np.float32)
    vals[..., 3] = 1.0
    for b in range(B_):
        n = int(rng.integers(P // 2, P))
        seg[b, n:] = V
        vals[b, n:] = 0
    return vals, slot, seg, V, S


def test_slot_outer_segment_sum_matches_pallas():
    """K3's plain version against both Pallas forms in interpret mode:
    counts (the 0/1 channel) exact, sums at 1e-5 (f32, another order; the
    Pallas kernel's hi/lo split is exact to about 2^-16 of each term)."""
    vals, slot, seg, V, S = slot_case(np.random.default_rng(0))
    got = targets.slot_outer_segment_sum_plain(
        torch.from_numpy(vals), torch.from_numpy(slot),
        torch.from_numpy(seg), S, V).numpy()
    with pltpu.force_tpu_interpret_mode():
        a = np.asarray(jseg.slot_outer_segment_sum_pallas(
            jnp.asarray(vals), jnp.asarray(slot), jnp.asarray(seg), S, V,
            chunk=128))
        b = np.asarray(jseg_t.slot_outer_segment_sum_t(
            jnp.asarray(vals.transpose(0, 2, 1)), jnp.asarray(slot),
            jnp.asarray(seg), S, V, chunk=256))
    for want in (a, b):
        assert got.shape == want.shape == (B, V, S, 4)
        np.testing.assert_array_equal(got[..., 3], want[..., 3])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[..., 3].sum() == (seg < V).sum()
    assert (got[:, V - 3:] == 0).all()          # empty rows


def expand_case(rng, V=96, C=13, n_cells=1600, sentinel=0.0):
    feats = (rng.normal(size=(B, V, C)) * 1000).astype(np.float32)
    keys = np.zeros((B, V), np.int32)
    for b in range(B):
        nv = int(rng.integers(40, 80))
        keys[b, :nv] = np.sort(rng.choice(n_cells, nv, replace=False))
        keys[b, nv:] = n_cells
        feats[b, nv:] = sentinel
    return feats, keys, n_cells


@pytest.mark.parametrize("sentinel", [0.0, 1.5])
def test_expand_rows_matches_pallas(sentinel):
    """K4's plain version against the Pallas kernel in interpret mode:
    exact on every cell.  The JAX contract sums the sentinel rows into row
    n_cells; the port writes 0 there.  The two agree when the sentinel
    rows are zero, as the targets' are (an empty pillar's moments are
    zero), and the targets drop that row either way."""
    feats, keys, n_cells = expand_case(np.random.default_rng(7),
                                       sentinel=sentinel)
    got = targets.expand_rows_plain(torch.from_numpy(feats),
                                    torch.from_numpy(keys), n_cells).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(lambda f, k: jseg.expand_rows_pallas(
            f, k, n_cells, chunk=512))(jnp.asarray(feats), jnp.asarray(keys)))
    assert got.shape == want.shape == (B, n_cells + 1, 13)
    np.testing.assert_array_equal(got[:, :n_cells], want[:, :n_cells])
    assert (got[:, n_cells] == 0).all()
    if sentinel == 0.0:
        np.testing.assert_array_equal(got, want)


def test_normal_and_curvature6_match_jax():
    """Same arithmetic in the same order: eigenvalues and curvature at
    1e-5 relative, signed normals at 1e-4 (the cross-product choice, and
    so the sign, agrees), degenerate and isotropic cases exactly."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 10, 3)).astype(np.float32)
    X[:100, :, 2] *= 1e-2                       # flat clouds
    A = np.einsum("nki,nkj->nij", X, X)
    A[0] = 0
    A[1] = np.eye(3)
    c6 = np.asarray(jeig3.pack_sym(jnp.asarray(A)))
    assert np.array_equal(eig3.pack_sym(torch.from_numpy(A)).numpy(), c6)
    wn, wc = jeig3.normal_and_curvature6(jnp.asarray(c6))
    gn, gc = eig3.normal_and_curvature6(torch.from_numpy(c6.copy()))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=1e-4)
    np.testing.assert_allclose(
        eig3.eigvals_sym6(torch.from_numpy(c6.copy())).numpy(),
        np.asarray(jeig3.eigvals_sym6(jnp.asarray(c6))), rtol=1e-5, atol=1e-5)
    assert gn[0].tolist() == [0.0, 0.0, 1.0]
    assert gn[1].tolist() == np.asarray(wn[1]).tolist()


def separated(curv, valid):
    """Pillars whose two smallest eigenvalues are well apart (R1 in
    ROADMAP.md): the normal is then defined up to sign."""
    c = np.asarray(curv)
    return np.asarray(valid) & (c[..., 1] - c[..., 2] > 1e-2 * c[..., 0])


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_targets_match_jax(tiny, route):
    """``compute_targets_batch`` against both JAX routes (K3 + K4 in
    interpret mode, the port's route; and the XLA one-hot cumsum):
    occupancy exact, centroids and curvature at 1e-5 against the Pallas
    route; 1e-4 against the XLA route, which sums each (pillar, slot) as
    the difference of two prefix sums over the whole sample, so its f32
    error grows with the running sum (4.1e-5 here, in units of a sub-voxel
    edge); normals by |cos| > 1 - 1e-4 on pillars with separated small
    eigenvalues, and equal sign on almost all of them."""
    if route == "pallas":
        with pltpu.force_tpu_interpret_mode():
            want = jmae.compute_targets_batch(tiny.js, tiny.jc,
                                              use_pallas=True)
    else:
        want = jmae.compute_targets_batch(tiny.js, tiny.jc, use_pallas=False)
    got = mae.compute_targets_batch(tiny.ts, tiny.tc)
    tol = 1e-5 if route == "pallas" else 1e-4
    for name in ("low_occ", "med_occ"):
        w = np.asarray(getattr(want, name))
        assert np.array_equal(getattr(got, name).numpy(), w), name
        assert w.any()
    for name in ("low_tgt", "med_tgt", "centroid_top"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    sel = separated(want.curv, tiny.js.table.valid)
    # the closed form's arccos is steep where two eigenvalues (nearly)
    # coincide: there it turns input rounding into about sqrt(2^-24) =
    # 2.4e-4 of the spectrum (1.6e-4 measured), so 1e-3 off `sel`
    gc, wc = got.curv.numpy(), np.asarray(want.curv)
    np.testing.assert_allclose(gc[sel], wc[sel], rtol=tol, atol=tol)
    np.testing.assert_allclose(gc, wc, atol=1e-3)
    assert sel.sum() > 0.5 * np.asarray(tiny.js.table.valid).sum()
    a, b = got.normal.numpy()[sel], np.asarray(want.normal)[sel]
    cos = (a * b).sum(-1)
    assert (np.abs(cos) > 1 - 1e-4).all()
    assert (cos > 0).mean() > 0.99
    v = np.asarray(tiny.js.table.valid)
    assert (got.normal.numpy()[~v] == 0).all()


def test_sample_mask_and_compaction(tiny):
    """``sample_mask`` keeps floor(0.3 n_valid) valid rows, a subset, and
    a different subset for another seed; ``compact_visible`` of the JAX
    keep equals the JAX compaction."""
    valid = tiny.ts.table.valid
    keep = mae.sample_mask(torch.Generator().manual_seed(0), valid, 0.7)
    other = mae.sample_mask(torch.Generator().manual_seed(1), valid, 0.7)
    assert not (keep & ~valid).any()
    n = valid.sum(1)
    assert torch.equal(keep.sum(1), torch.floor(n.float() * 0.3).long())
    assert not torch.equal(keep, other)
    full = torch.ones(1, 10, dtype=torch.bool)
    assert mae.sample_mask(torch.Generator().manual_seed(0), full,
                           0.0).all()
    vis_cap = tiny.tc.caps.max_visible
    wi, wv = jax.vmap(lambda k: jmae.compact_visible(k, vis_cap))(tiny.keep)
    gi, gv = mae.compact_visible(tiny.tkeep, vis_cap)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


def test_gather_injective_matches_jax():
    """Forward and backward (the inverse gather) against the JAX custom
    VJP under vmap: exact."""
    rng = np.random.default_rng(5)
    N, M, C = 40, 16, 3
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = np.full((B, M), 2 ** 31 - 1, np.int32)
    inv = np.full((B, N), 2 ** 31 - 1, np.int32)
    for b in range(B):
        rows = np.sort(rng.choice(N, 11, replace=False))
        idx[b, :11] = rows
        inv[b, rows] = np.arange(11)
    g = rng.normal(size=(B, M, C)).astype(np.float32)

    def f(x_):
        return jnp.sum(jax.vmap(jscatter.gather_injective)(
            x_, jnp.asarray(idx), jnp.asarray(inv)) * g)

    want_dx = np.asarray(jax.grad(f)(jnp.asarray(x)))
    want = np.asarray(jax.vmap(jscatter.gather_injective)(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(inv)))
    tx = torch.from_numpy(x).requires_grad_()
    out = scatter.gather_injective(tx, torch.from_numpy(idx),
                                   torch.from_numpy(inv))
    (out * torch.from_numpy(g)).sum().backward()
    assert np.array_equal(out.detach().numpy(), want)
    assert np.array_equal(tx.grad.numpy(), want_dx)


def test_decoder_pair_matches_jax(tiny):
    """The two ungrouped decoder stacks against the JAX ``SSTStackPair``
    (grouped over G = 2) through ``from_flax``: 1e-4 on valid rows (two
    post-norm layers per branch in f32, sums over 32 channels and windows
    of up to 144 tokens in other orders)."""
    cfg, js = tiny.jc, tiny.js
    V = cfg.caps.max_voxels
    x = np.random.default_rng(1).normal(
        0, 0.5, (B, V, cfg.sst.d_model)).astype(np.float32)
    coords, valid = js.table.coords, js.table.valid
    shift = jax_shift_data(jwin.make_layouts(coords, valid, cfg.sst,
                                             cfg.voxel),
                           None, valid, cfg.sst, cfg.voxel)
    pair = JaxPair(cfg.sst, cfg.mae.decoder_blocks, 2, jnp.float32)
    want = np.asarray(jax.jit(pair.apply)(
        {"params": tiny.params["decoders"]}, jnp.asarray(x), shift))
    model = port_model(tiny)
    tc, tv = tiny.ts.table.coords, tiny.ts.table.valid
    tshift = prepare_shift_data(windows.make_layouts(tc, tv, tiny.tc.sst,
                                                     tiny.tc.voxel), tv,
                                tiny.tc.sst)
    with torch.no_grad():
        got = model.backbone.decoders(torch.from_numpy(x), tshift).numpy()
    v = np.asarray(valid)
    assert got.shape == want.shape == (2, B, V, cfg.sst.d_model)
    for g in range(2):
        np.testing.assert_allclose(got[g][v], want[g][v], rtol=1e-4,
                                   atol=1e-4)
    assert np.abs(got[0][v] - got[1][v]).max() > 0.1      # two branches


def jax_preds(tiny, train=False):
    net = jmae.GeoMAE(tiny.jc)
    return jax.jit(lambda p, s, sc, k: net.apply(
        {"params": p, "batch_stats": s}, sc, k, train=False))(
        tiny.params, tiny.stats, tiny.js, tiny.keep)


def test_geomae_predictions_match_jax(tiny):
    """GeoMAE in eval mode on the JAX keep, weights loaded strictly
    through ``from_flax``: every head at 2e-4 (the VFE, two encoder and
    two decoder layers per branch in f32, then the heads)."""
    want = jax_preds(tiny)
    model = port_model(tiny).eval()
    with torch.no_grad():
        got = model(tiny.ts, tiny.tkeep)
    assert set(got) == set(want)
    v = np.asarray(tiny.js.table.valid)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy()[v], w[v], rtol=2e-4,
                                   atol=2e-4, err_msg=k)


def test_pretrain_loss_matches_jax(tiny):
    """``pretrain_loss`` of the same predictions and targets (the JAX
    targets, carried across): each term at 1e-6 relative (f32 means over
    the masked rows in another order)."""
    rng = np.random.default_rng(9)
    want_t = jmae.compute_targets_batch(tiny.js, tiny.jc, use_pallas=False)
    got_t = mae.GeoMAETargets(*[torch.from_numpy(np.array(a))
                                for a in want_t])
    V = tiny.jc.caps.max_voxels
    S, M = tiny.jc.voxel.num_slots_low, tiny.jc.voxel.num_slots_med
    shapes = dict(reg_low=(B, V, S, 3), reg_med=(B, V, M, 3),
                  reg_top=(B, V, 3), nor_top=(B, V, 3),
                  cls_low=(B, V, S, 2), cls_med=(B, V, M, 2))
    preds = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    want = jmae.pretrain_loss({k: jnp.asarray(v) for k, v in preds.items()},
                              want_t, tiny.js, tiny.keep, tiny.jc)
    got = mae.pretrain_loss({k: torch.from_numpy(v) for k, v in preds.items()},
                            got_t, tiny.ts, tiny.tkeep, tiny.tc)
    assert set(got) == set(want) and len(got) == 7
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_geomae_state_dict_is_the_reference_layout(tiny):
    """The port's GeoMAE state_dict in the reference checkpoint's names:
    the JAX package's importer (kind "pretrain") takes every key and fills
    every flax leaf, and ``from_flax`` gives the same values back."""
    model = port_model(tiny)
    g = torch.Generator().manual_seed(1)
    sd = {k: (torch.rand(v.shape, generator=g) + 0.5
              if v.is_floating_point() else v)
          for k, v in model.state_dict().items()}
    zeros = lambda t: jax.tree.map(np.zeros_like, t)
    p2, s2, report = import_torch_weights(
        zeros(tiny.params), zeros(tiny.stats),
        {k: v.numpy() for k, v in sd.items()}, "pretrain")
    assert report["missing"] == [] and report["unconsumed"] == []
    back = from_flax(jax.tree.map(np.asarray, p2),
                     jax.tree.map(np.asarray, s2))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    assert "backbone.mask_token" in sd
    assert "backbone.decoder_density_blocks.0.encoder_list.1.linear2.bias" \
        in sd


def test_port_imports_nothing_of_the_jax_package():
    """``geomae_tpu_torch``, every module in it (the trainer, checkpoint,
    loader, logging, CLI and data-parallel modules, the data preparation,
    the misc tools and the VoxelNet and point-op modules among them), and
    ``chip_smoke`` load no module named ``geomae_tpu`` or
    ``geomae_tpu.*``, and no JAX, flax, optax or orbax."""
    code = (
        "import importlib, pkgutil, sys, geomae_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(geomae_tpu_torch.__path__, "
        "'geomae_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'geomae_tpu'))\n"
        "n = sum(m.startswith('geomae_tpu_torch.') for m in sys.modules)\n"
        "new = ['train.trainer', 'train.checkpoint', 'train.state', "
        "'train.__main__', 'data.loader', 'data.synthetic', "
        "'utils.logging', 'parallel.mesh', 'parallel.distributed', "
        "'create_data', 'misc_tools', 'data.converters', "
        "'data.kitti_converter', 'data.waymo_converter', "
        "'models.pillar_encoders', 'ops.pointnet_ops', 'ops.k_medoids', "
        "'core.box_modes', 'core.visualize']\n"
        "bad += [m for m in new if 'geomae_tpu_torch.' + m not in "
        "sys.modules]\n"
        "sys.exit(str(bad) if bad or n < 45 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
