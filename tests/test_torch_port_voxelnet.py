"""The port's VoxelNet family against the JAX package at tiny width, f32,
on the CPU (plain versions of the kernels): ``hard_voxelize``,
``lookup_rows`` and ``neighbor_rows`` exactly; the dynamic VFE with
``with_distance``, the simple encoders, ``HardVFE`` and
``PillarFeatureNet`` at 1e-5 (1e-4 with batch statistics); the whole
``VoxelNet``
with either encoder from ``from_flax`` weights (``strict=True``) at 1e-4
in both BN modes, its batch statistics, and the pillar model's
gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.config import tiny_finetune_config
from geomae_tpu.models import pillar_encoders as jpe
from geomae_tpu.models.detector import VoxelNet as JaxVoxelNet
from geomae_tpu.models.vfe import DynamicScatterVFE as JaxVFE
from geomae_tpu.ops import voxelize as jvox
from geomae_tpu_torch.models import pillar_encoders as tpe
from geomae_tpu_torch.models.detector import (VoxelNet, init_weights,
                                              init_weights_reference)
from geomae_tpu_torch.models.vfe import DynamicScatterVFE
from geomae_tpu_torch.ops import voxelize as tvox
from geomae_tpu_torch.weights import from_flax

B = 2
T = 4                # slots of a hard voxel: the tiny scenes' pillars hold 8
# an encoder's tolerance by BN mode: in training the statistics are
# one-pass f32 moments, E[x^2] - E[x]^2 over ~3,200 points summed in other
# orders, whose cancellation reaches 4e-5 on features of order 1
ENC_TOL = {False: 1e-5, True: 1e-4}


def spread_points(rng, cfg, n_pillars=200, per_pillar=8):
    """Points in ``n_pillars`` pillars spread over the whole grid, 8 a
    pillar, under a padded suffix."""
    vx, vy, _ = cfg.voxel.voxel_size
    r = cfg.voxel.point_cloud_range
    ny, nx = cfg.voxel.grid_size
    pts = np.zeros((B, cfg.caps.max_points, 5), np.float32)
    valid = np.zeros((B, cfg.caps.max_points), bool)
    n = n_pillars * per_pillar
    for b in range(B):
        cells = rng.choice(ny * nx, n_pillars, replace=False)
        cy, cx = cells // nx, cells % nx
        pts[b, :n, 0] = r[0] + (np.repeat(cx, per_pillar)
                                + rng.uniform(0.05, 0.95, n)) * vx
        pts[b, :n, 1] = r[1] + (np.repeat(cy, per_pillar)
                                + rng.uniform(0.05, 0.95, n)) * vy
        pts[b, :n, 2] = rng.uniform(-2.0, 0.5, n)
        pts[b, :n, 3:] = rng.uniform(0, 0.5, (n, 2))
        valid[b, :n] = True
    return pts, valid


def to_port(js) -> tvox.Scene:
    """The JAX scene's arrays as the port's Scene (same row order)."""
    t = lambda a: torch.from_numpy(np.array(a))
    return tvox.Scene(points=t(js.points), valid=t(js.valid),
                      table=tvox.VoxelTable(*map(t, js.table)),
                      slot_low=t(js.slot_low), slot_med=t(js.slot_med),
                      slot_sort=t(js.slot_sort))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_finetune_config()
    pts, valid = spread_points(np.random.default_rng(0), cfg)
    build = jax.jit(jvox.build_scene_batch, static_argnums=(2, 3))
    js = build(jnp.asarray(pts), jnp.asarray(valid), cfg.voxel,
               cfg.caps.max_voxels)
    # a second scene past its row cap: points of pillars past 64 rows
    # carry the sentinel
    jo = build(jnp.asarray(pts), jnp.asarray(valid), cfg.voxel, 64)
    return cfg, js, jo


def random_variables(module, *args, seed: int = 0):
    """Seeded flax variables of ``module`` for ``args``, drawn with numpy
    on the shapes of its init (traced, not compiled): kernels from
    +-1/sqrt(fan_in), biases and BN means N(0, 0.1), scales 1 + N(0, 0.1),
    BN variances 1 + |N(0, 0.2)|, so no two leaves agree by accident."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                train=False))

    def draw(path, a):
        name, shape = path[-1].key, a.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == "var":
            v = 1 + np.abs(rng.normal(0, 0.2, shape))
        else:
            v = (name == "scale") + rng.normal(0, 0.1, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def encoder_state(variables) -> dict:
    """A standalone encoder's flax variables -> its own ``state_dict``
    (``from_flax`` maps them under ``voxel_encoder``)."""
    sd = from_flax({"voxel_encoder": variables["params"]},
                   {"voxel_encoder": variables.get("batch_stats", {})})
    return {k[len("voxel_encoder."):]: v for k, v in sd.items()}


def run_jax(module, variables, *args, train: bool):
    """(output, new batch statistics) of a flax module, compiled."""
    out, new = _apply(module, variables, *args, train=train)
    return out, new.get("batch_stats", {})


@jax.jit
def _hard_voxelize(scene):
    return jax.vmap(lambda s: jvox.hard_voxelize(s, T))(scene)


# one compiled program per (module, shapes, mode) for the whole file
_apply = jax.jit(lambda m, v, *a, train: m.apply(v, *a, train=train,
                                                 mutable=["batch_stats"]),
                 static_argnums=0, static_argnames="train")


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capped", [False, True])
def test_hard_voxelize_matches_jax(tiny, capped):
    """Every slot and count bitwise: points past T slots, invalid points
    and (``capped``) the points of pillars past the row cap fill none."""
    _, js, jo = tiny
    scene = jo if capped else js
    want_v, want_n = _hard_voxelize(scene)
    got_v, got_n = tvox.hard_voxelize(to_port(scene), T)
    assert got_n.dtype == torch.int32
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))
    # 200 pillars a sample: empty rows under the cap of 256, none under 64
    assert int(got_n.max()) == T and int(got_n.min()) == (T if capped else 0)


def test_lookup_and_neighbor_rows_match_jax(tiny):
    cfg, js, _ = tiny
    ny, nx = cfg.voxel.grid_size
    coords, valid = js.table.coords, js.table.valid
    rng = np.random.default_rng(3)
    keys = rng.integers(0, ny * nx, (B, 50, 3)).astype(np.int32)
    hits = np.asarray(coords[:, :20, 0] * nx + coords[:, :20, 1])
    keys[:, :20, 0] = hits                       # every table row found
    ok = rng.random((B, 50, 3)) < 0.8
    want = jax.jit(jax.vmap(lambda c, v, q, o: jvox.lookup_rows(
        c, v, ny, nx, q, o)))(coords, valid, jnp.asarray(keys),
                              jnp.asarray(ok))
    tc, tv = (torch.from_numpy(np.array(a)) for a in (coords, valid))
    got = tvox.lookup_rows(tc, tv, ny, nx, torch.from_numpy(keys),
                           torch.from_numpy(ok))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    v_cap = cfg.caps.max_voxels
    assert (got.numpy()[:, :20, 0][ok[:, :20, 0]] < v_cap).all()
    want = jax.jit(jax.vmap(lambda c, v: jvox.neighbor_rows(
        c, v, ny, nx, v_cap)))(coords, valid)
    got = tvox.neighbor_rows(tc, tv, ny, nx, v_cap)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the centre tap is the row itself
    rows = np.arange(v_cap)
    assert np.array_equal(got.numpy()[:, :, 4][np.asarray(valid)],
                          np.broadcast_to(rows, (B, v_cap))[np.asarray(valid)])


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_dynamic_vfe_with_distance_matches_jax(tiny, train):
    """The distance feature widens the first layer to 12 inputs."""
    cfg, js, _ = tiny
    vcfg = dataclasses.replace(cfg.vfe, with_distance=True)
    jm = JaxVFE(vcfg, cfg.voxel, jnp.float32)
    var = random_variables(jm, js, seed=1)
    want, stats = run_jax(jm, var, js, train=train)
    tm = DynamicScatterVFE(vcfg, cfg.voxel)
    tm.load_state_dict(encoder_state(var), strict=True)
    assert tm.vfe_layers[0].linear.in_features == 12
    tm.train(train)
    close(tm(to_port(js), torch.float32), want, ENC_TOL[train])
    if train:
        close(tm.vfe_layers[1].norm.running_var,
              stats["vfe_1"]["norm"]["var"], 1e-5)


def test_simple_encoders_match_jax(tiny):
    """The hard mean at 1e-5; the dynamic one at 1e-4, as the JAX CPU path
    takes each pillar's sum as a difference of a running sum over the
    whole cloud (``ops/scatter.segment_mean(sorted_ids=True)``)."""
    _, js, jo = tiny
    for scene in (js, jo):
        want = jax.jit(jpe.dynamic_simple_vfe)(scene)
        close(tpe.dynamic_simple_vfe(to_port(scene)), want, 1e-4)
        jv, jn = _hard_voxelize(scene)
        want = jax.jit(jpe.hard_simple_vfe)(jv, jn)
        got = tpe.hard_simple_vfe(torch.from_numpy(np.array(jv)),
                                  torch.from_numpy(np.array(jn)))
        close(got, want, 1e-5)
        assert np.abs(np.asarray(want)).max() > 1.0


@pytest.mark.parametrize("train", [False, True])
def test_hard_vfe_matches_jax(tiny, train):
    """Decorations with distance, BN statistics over the written slots,
    the max over every slot (empty ones as ``relu(BN(0))``)."""
    cfg, js, _ = tiny
    vcfg = dataclasses.replace(cfg.vfe, with_distance=True)
    jv, jn = _hard_voxelize(js)
    coords = js.table.coords
    jm = jpe.HardVFE(vcfg, cfg.voxel)
    var = random_variables(jm, jv, jn, coords, seed=2)
    want, stats = run_jax(jm, var, jv, jn, coords, train=train)
    tm = tpe.HardVFE(vcfg, cfg.voxel)
    tm.load_state_dict(encoder_state(var), strict=True)
    tm.train(train)
    got = tm(*(torch.from_numpy(np.array(a)) for a in (jv, jn, coords)))
    close(got, want, ENC_TOL[train])
    if train:
        close(tm.vfe_layers[0].norm.running_mean,
              stats["vfe_0_norm"]["mean"], 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_pillar_feature_net_matches_jax(tiny, train):
    cfg, js, jo = tiny
    vcfg = dataclasses.replace(cfg.vfe, with_distance=True)
    jm = jpe.PillarFeatureNet(vcfg, cfg.voxel)
    var = random_variables(jm, js, seed=3)
    tm = tpe.PillarFeatureNet(vcfg, cfg.voxel)
    tm.load_state_dict(encoder_state(var), strict=True)
    assert [k.split(".")[0] for k in tm.state_dict()] == ["pfn_layers"] * 12
    tm.train(train)
    # the scene past its row cap (VoxelNet's tests run the other)
    want, _ = run_jax(jm, var, jo, train=train)
    close(tm(to_port(jo), torch.float32), want, ENC_TOL[train])


# ---------------------------------------------------------------------------
# VoxelNet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["pillar", "simple"])
def voxelnet(request, tiny):
    """A JAX VoxelNet's random variables and the port's model loaded from
    them."""
    cfg, js, _ = tiny
    net = JaxVoxelNet(cfg, encoder=request.param, max_points_per_voxel=T)
    var = random_variables(net, js, seed=4)
    model = VoxelNet(cfg, encoder=request.param, max_points_per_voxel=T)
    model.load_state_dict(from_flax(var["params"],
                                    var.get("batch_stats", {})), strict=True)
    return request.param, net, var, model


@pytest.mark.parametrize("train", [False, True])
def test_voxelnet_matches_jax(tiny, voxelnet, train):
    """Head outputs at 1e-4 (as the detector tests); after a train-mode
    forward, every BN running statistic at 1e-5."""
    _, js, _ = tiny
    encoder, net, var, model = voxelnet
    want, stats = run_jax(net, var, js, train=train)
    model.train(train)
    with torch.no_grad():
        got = model(to_port(js))
    for name in ("cls", "reg", "dir"):
        w = np.moveaxis(np.asarray(getattr(want, name)), -1, 1)
        close(getattr(got, name), w, 1e-4)
    if train:
        after = from_flax(var["params"], stats)
        for k, v in model.state_dict().items():
            if "running_" in k:
                close(v, after[k].numpy(), 1e-5)
    model.load_state_dict(from_flax(var["params"],
                                    var.get("batch_stats", {})))
    width = model.backbone.conv_blocks[0][0].in_channels
    assert width == (4 if encoder == "simple" else 32)


def test_voxelnet_gradients_match_jax(tiny, voxelnet):
    """Every parameter's gradient of a fixed random weighting of the head
    outputs in train mode, at 1e-4 relative norm error (through the plain
    versions of K1's and K2's backward in the pillar encoder)."""
    _, js, _ = tiny
    _, net, var, model = voxelnet
    names = ("cls", "reg", "dir")
    shapes, _ = jax.eval_shape(lambda v, s: net.apply(
        v, s, train=True, mutable=["batch_stats"]), var, js)
    rng = np.random.default_rng(5)
    w = {n: rng.normal(size=getattr(shapes, n).shape).astype(np.float32)
         for n in names}

    def loss(params):
        out, _ = net.apply({"params": params,
                            "batch_stats": var.get("batch_stats", {})},
                           js, train=True, mutable=["batch_stats"])
        return sum((getattr(out, n) * w[n]).sum() for n in names)
    want = from_flax(jax.jit(jax.grad(loss))(var["params"]), {})
    model.train()
    model.zero_grad()
    out = model(to_port(js))
    sum((getattr(out, n) * torch.from_numpy(np.moveaxis(w[n], -1, 1))).sum()
        for n in names).backward()
    params = dict(model.named_parameters())
    assert params.keys() == want.keys()
    for k, p in params.items():
        err = float((p.grad - want[k]).norm() / want[k].norm())
        assert err <= 1e-4, (k, err)
    model.load_state_dict(from_flax(var["params"],
                                    var.get("batch_stats", {})))


def test_init_covers_the_new_modules(tiny):
    """Both initialisers fill every tensor of either VoxelNet; the pillar
    Linears draw from +-sqrt(1/fan_in), the JAX ``torch_linear_init``."""
    cfg = tiny[0]
    for encoder in ("pillar", "simple"):
        model = VoxelNet(cfg, encoder=encoder, device="meta").to_empty(
            device="cpu")
        for init in (init_weights, init_weights_reference):
            for t in model.state_dict().values():
                if t.is_floating_point():
                    t.fill_(float("nan"))
            init(model, torch.Generator().manual_seed(0))
            assert all(bool(torch.isfinite(t.float()).all())
                       for t in model.state_dict().values())
    w = model.backbone.conv_blocks[0][0].weight
    assert w.shape[1] == 4
    model = VoxelNet(cfg)
    init_weights_reference(model, torch.Generator().manual_seed(0))
    lin = model.voxel_encoder.pfn_layers[0].linear.weight
    assert float(lin.detach().abs().max()) <= (1.0 / lin.shape[1]) ** 0.5
