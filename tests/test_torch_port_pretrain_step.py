"""The port's GeoMAE pretrain step against the JAX package's, f32, on the
CPU (plain versions of the kernels): ``tiny_pretrain_config()``, batch 2,
the same weights (``from_flax``, which is linear, so it also carries the
JAX gradient tree across), the same points and the same keep mask (drawn
by the JAX sampler and handed to the port); losses, every gradient, the
parameters and batch statistics after one update, and the decay mask.
The JAX targets take the route the port takes (K3 and K4, here in
interpret mode)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import geomae_tpu.config as jcfg
import geomae_tpu_torch.config as tcfg
from geomae_tpu.models import mae as jmae
from geomae_tpu.ops.voxelize import build_scene_batch as jax_build
from geomae_tpu.train.optim import decay_mask as jax_decay_mask
from geomae_tpu.train.optim import make_optimizer
from geomae_tpu_torch.models.mae import GeoMAE
from geomae_tpu_torch.train import pretrain as PT
from geomae_tpu_torch.train.finetune import TrainState
from geomae_tpu_torch.train.optim import AdamW, decay_mask
from geomae_tpu_torch.weights import from_flax
from test_torch_port_pretrain_ops import frames, randomized_geomae


@pytest.fixture(scope="module")
def step():
    """One JAX step (losses, gradients, new batch statistics and
    parameters) and the port's step from the same state, batch and
    mask."""
    jc, tc = jcfg.tiny_pretrain_config(), tcfg.tiny_pretrain_config()
    params, stats = randomized_geomae(jc, seed=1)
    pts, valid = frames(tc, 3)
    batch = dict(points=jnp.asarray(pts), point_valid=jnp.asarray(valid))
    scene = jax_build(batch["points"], batch["point_valid"], jc.voxel,
                      jc.caps.max_voxels)
    keep = jmae.sample_mask(jax.random.PRNGKey(2), scene.table.valid,
                            jc.mae.random_mask_ratio)
    with pltpu.force_tpu_interpret_mode():
        targets = jmae.compute_targets_batch(scene, jc, use_pallas=True)
    net = jmae.GeoMAE(jc)
    tx = make_optimizer(jc.optim)

    @jax.jit
    def jax_step(p, s, sc, tg, k):
        def loss_fn(p_):
            preds, mut = net.apply({"params": p_, "batch_stats": s}, sc, k,
                                   train=True, mutable=["batch_stats"])
            losses = jmae.pretrain_loss(preds, tg, sc, k, jc)
            return losses["loss"], (losses, mut["batch_stats"])

        (_, (losses, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        upd, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, new_stats, optax.apply_updates(p, upd)

    losses, grads, new_stats, new_params = jax_step(params, stats, scene,
                                                    targets, keep)

    model = GeoMAE(tc)
    before = from_flax(params, stats)
    model.load_state_dict(before, strict=True)
    state = TrainState(step=0, model=model, tx=AdamW(model, tc.optim))
    train_step = PT.make_train_step(tc)
    tb = dict(points=torch.from_numpy(pts), point_valid=torch.from_numpy(valid))
    tkeep = torch.from_numpy(np.array(keep))
    # the step's own parts, to see the gradients before the clip
    model.train()
    got = train_step.loss_fn(model, tb, keep=tkeep)
    got["loss"].backward()
    port_grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    state.tx.step()
    return SimpleNamespace(
        params=params, losses=losses, grads=from_flax(grads, {}),
        after=from_flax(new_params, new_stats), before=before,
        port_losses={k: float(v.detach()) for k, v in got.items()},
        port_grads=port_grads, port_after=model.state_dict(),
        lr=state.tx.lr(0), model=model)


def test_losses_match_jax(step):
    """Tolerance 1e-5 relative: f32 means over the masked rows, and
    targets that agree to 1e-5, in another order."""
    assert set(step.port_losses) == set(step.losses)
    for k, v in step.port_losses.items():
        np.testing.assert_allclose(v, float(step.losses[k]), rtol=1e-5,
                                   err_msg=k)


def test_every_gradient_matches_jax(step):
    """Each parameter's gradient at 1e-4 relative norm error: f32 sums in
    other orders through the VFE, two encoder layers, two layers per
    decoder branch and the heads, both directions."""
    assert set(step.grads) == set(step.port_grads)
    for k, g in step.grads.items():
        err = float((step.port_grads[k] - g).norm() / g.norm())
        assert err <= 1e-4, (k, err)
    assert float(step.grads["backbone.mask_token"].norm()) > 0


def test_parameters_after_one_step_match_jax(step):
    """AdamW's first update is lr * g / (|g| + 1e-8) (after the clip,
    which scales g uniformly), about lr * sign(g).  Where |g| exceeds a
    tenth of its tensor's root mean square and 100 x AdamW's epsilon
    (below that the update is no longer a sign, and a relative error r of
    g moves it by up to r * 1e-8 / |g|: the density branch's gradients,
    fed by the normal loss alone, reach down there) the updates agree to
    1e-3 lr; elsewhere rounding may flip the sign (the key bias's
    gradient is zero but for rounding), so there they are held to 2 lr.
    Both bounds add two f32 ulps of the parameter: each side rounds the
    updated parameter to f32 once, after adding the step and the weight
    decay in its own order (an ulp of a weight of 0.25 is 3e-3 lr at
    lr 1e-5)."""
    n_sel = 0
    ulp = torch.finfo(torch.float32).eps
    for k, want in step.after.items():
        if "running_" in k or k.endswith("num_batches_tracked"):
            continue
        d = ((step.port_after[k] - step.before[k])
             - (want - step.before[k])).abs() / step.lr
        d = d - 2 * ulp * step.before[k].abs() / step.lr
        g = step.grads[k].abs()
        sel = (g > 0.1 * g.square().mean().sqrt()) & (g > 1e-6)
        n_sel += int(sel.sum())
        assert float(d[sel].max()) <= 1e-3, k
        assert float(d.max()) <= 2.001, k
    # the selection holds most elements (58,925 of 93,638 here)
    assert n_sel > 0.5 * sum(p.numel() for p in step.model.parameters())


def test_batch_statistics_after_one_step_match_jax(step):
    """The VFE's running mean and var at 1e-5 + 1e-4 relative (f32 masked
    moments in another order); the port also counts the update."""
    n = 0
    for k, want in step.after.items():
        if k.endswith("num_batches_tracked"):
            assert int(step.port_after[k]) == 1, k
        elif "running_" in k:
            np.testing.assert_allclose(step.port_after[k].numpy(),
                                       want.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            assert not torch.equal(want, step.before[k]), k
            n += 1
    assert n == 4


def test_decay_mask_matches_jax(step):
    """The JAX mask drops every path containing "norm" and the
    ``mask_token``; the port's from module types and the name, the same
    parameter by parameter."""
    mask = jax_decay_mask(step.params)
    full = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), m), step.params, mask)
    want = {k: bool(v.all()) for k, v in from_flax(full, {}).items()}
    names = [k for k, _ in step.model.named_parameters()]
    got = dict(zip(names, decay_mask(step.model)))
    assert got == want
    assert not got["backbone.mask_token"]
    assert got["backbone.decoder_pred_low.weight"]


def test_loss_falls_with_a_fixed_mask():
    """Six port steps from seeded weights on one synthetic batch with a
    mask generator seeded alike each step: every loss finite, the last
    below the first, every parameter moved; the mask follows its
    generator."""
    cfg = tcfg.tiny_pretrain_config()
    state = PT.init_state(cfg, "cpu", torch.Generator().manual_seed(1))
    train_step = PT.make_train_step(cfg)
    batch = PT.synthetic_batch(cfg, 2, seed=3, device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    losses = []
    for _ in range(6):
        state, out = train_step(state, batch,
                                torch.Generator().manual_seed(5))
        assert len(out) == 7
        assert all(np.isfinite(float(v)) for v in out.values())
        losses.append(float(out["loss"]))
    assert losses[-1] < losses[0]
    assert state.step == 6 and state.tx.count == 6
    for a, p in zip(before, state.model.parameters()):
        assert not torch.equal(a, p.detach())
    _, t1, k1 = PT.targets_and_mask(cfg, batch,
                                    torch.Generator().manual_seed(5))
    _, t2, k2 = PT.targets_and_mask(cfg, batch,
                                    torch.Generator().manual_seed(6))
    assert not torch.equal(k1, k2) and torch.equal(t1.low_occ, t2.low_occ)


def test_entry_points_default_to_the_card():
    """Every entry point's device defaults to "cuda"; the CPU is asked
    for."""
    import inspect

    from geomae_tpu_torch import apis
    from geomae_tpu_torch.train import finetune

    fns = (apis.init_model, apis.Detector3D.__init__, finetune.init_state,
           finetune.synthetic_batch, PT.init_state, PT.synthetic_batch)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
