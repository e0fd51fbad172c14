"""The port's fine-tune train step against the JAX package's, f32, on the
CPU (plain versions of the kernels): ``tiny_finetune_config()``, batch
2, the same weights (``from_flax``, which is linear, so it also carries
the JAX gradient tree across) and the same batch; losses, every
gradient, and the parameters and batch statistics after one update."""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geomae_tpu.config import tiny_finetune_config
from geomae_tpu.models.anchor_head import head_loss as jax_head_loss
from geomae_tpu.models.anchors import grid_anchors
from geomae_tpu.models.detector import DynamicVoxelNet as JaxNet
from geomae_tpu.train import finetune as JFT
from geomae_tpu.train.optim import decay_mask as jax_decay_mask
from geomae_tpu.train.optim import make_optimizer
from geomae_tpu_torch.models.detector import DynamicVoxelNet
from geomae_tpu_torch.train import finetune as FT
from geomae_tpu_torch.train.optim import AdamW, decay_mask
from geomae_tpu_torch.weights import from_flax
from test_torch_port_weights import randomized_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_and_port_step(cfg, state=None):
    """One compiled JAX step (losses, gradients, new batch statistics and
    parameters) and the port's step from the same state and batch, at the
    JAX config ``cfg`` (the port's modules read it too).  ``state`` is the
    flax (params, batch_stats), by default ``randomized_state``'s."""
    params, stats = state or randomized_state(cfg)
    batch = JFT.dummy_batch(cfg, 2, seed=5)
    net = JaxNet(cfg)
    anchors = jnp.asarray(grid_anchors(cfg.head, JFT.head_featmap_size(cfg)))
    tx = make_optimizer(cfg.optim)

    @jax.jit
    def jax_step(p, s, b):
        def loss_fn(p_):
            scene = JFT.extract_scene(cfg, b["points"], b["point_valid"])
            out, mut = net.apply({"params": p_, "batch_stats": s}, scene,
                                 train=True, mutable=["batch_stats"])
            losses = jax_head_loss(out, anchors, b["gt_boxes"],
                                   b["gt_labels"], b["gt_mask"], cfg.head)
            losses["loss"] = sum(losses.values())
            return losses["loss"], (losses, mut["batch_stats"])

        (_, (losses, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        upd, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, new_stats, optax.apply_updates(p, upd)

    losses, grads, new_stats, new_params = jax_step(params, stats, batch)

    model = DynamicVoxelNet(cfg)
    before = from_flax(params, stats)
    model.load_state_dict(before, strict=True)
    state = FT.TrainState(step=0, model=model, tx=AdamW(model, cfg.optim))
    train_step = FT.make_train_step(cfg)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    # the step's own parts, to see the gradients before the clip
    model.train()
    got = train_step.loss_fn(model, tb)
    got["loss"].backward()
    port_grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    state.tx.step()
    return SimpleNamespace(
        cfg=cfg, params=params, losses=losses,
        grads=from_flax(grads, {}), after=from_flax(new_params, new_stats),
        before=before, port_losses={k: float(v.detach())
                                    for k, v in got.items()},
        port_grads=port_grads, port_after=model.state_dict(),
        lr=state.tx.lr(0), model=model)


@pytest.fixture(scope="module")
def step():
    return jax_and_port_step(tiny_finetune_config())


def check_losses(step):
    """Tolerance 1e-5 relative: f32 focal, smooth-L1 and direction sums
    over 22,400 anchors in another order."""
    for k, v in step.port_losses.items():
        np.testing.assert_allclose(v, float(step.losses[k]), rtol=1e-5,
                                   err_msg=k)


def check_gradients(step):
    """Each parameter's gradient at 1e-4 relative norm error: f32 sums in
    other orders through the VFE, 4 SST layers and 11 convolutions, both
    directions (measured 2e-5 at most)."""
    assert set(step.grads) == set(step.port_grads)
    for k, g in step.grads.items():
        err = float((step.port_grads[k] - g).norm() / g.norm())
        assert err <= 1e-4, (k, err)


def test_losses_match_jax(step):
    check_losses(step)


def test_every_gradient_matches_jax(step):
    check_gradients(step)


def test_parameters_after_one_step_match_jax(step):
    """AdamW's first update is about lr * sign(g) (after the clip, which
    scales g uniformly).  Where |g| exceeds a tenth of its tensor's root
    mean square the updates agree to 1e-3 lr; below, rounding may flip
    the sign (the key bias's gradient is zero but for rounding), so there
    they are held to 2 lr."""
    n_sel = 0
    for k, want in step.after.items():
        if "running_" in k or k.endswith("num_batches_tracked"):
            continue
        d = ((step.port_after[k] - step.before[k])
             - (want - step.before[k])).abs() / step.lr
        g = step.grads[k].abs()
        sel = g > 0.1 * g.square().mean().sqrt()
        n_sel += int(sel.sum())
        assert float(d[sel].max()) <= 1e-3, k
        assert float(d.max()) <= 2.001, k
    # the tight bound covers most elements (79 % here)
    assert n_sel > 0.7 * sum(p.numel() for p in step.model.parameters())


def test_batch_statistics_after_one_step_match_jax(step):
    """Running mean and var at 1e-5 + 1e-4 relative (f32 masked moments
    in another order); the port also counts the update."""
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
    assert n == 2 * sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                        for m in step.model.modules())


def test_decay_mask_matches_jax(step):
    """The JAX mask drops every flax path containing "norm" (LayerNorms,
    and BatchNorms through their ``MaskedBatchNorm`` scopes); the port's
    names do not say "norm" for SECOND's and the FPN's BatchNorms, so its
    mask comes from the module types.  Same mask, parameter by
    parameter."""
    mask = jax_decay_mask(step.params)
    full = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), m), step.params, mask)
    want = {k: bool(v.all()) for k, v in from_flax(full, {}).items()}
    for k, v in from_flax(full, {}).items():
        assert bool(v.all()) == bool(v.any()), k
    names = [k for k, _ in step.model.named_parameters()]
    got = dict(zip(names, decay_mask(step.model)))
    assert got == want
    assert not got["backbone.conv_blocks.0.1.weight"]
    assert not got["neck.deblocks.0.1.bias"]
    assert got["backbone.conv_blocks.0.0.weight"]


def test_loss_falls_on_a_repeated_batch():
    """Five port steps from seeded weights on one ``clustered_scene``
    batch: every loss finite, the last below the first, every parameter
    moved."""
    cfg = tiny_finetune_config()
    state = FT.init_state(cfg, "cpu", torch.Generator().manual_seed(1))
    train_step = FT.make_train_step(cfg)
    batch = FT.synthetic_batch(cfg, 2, seed=3, device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    losses = []
    for _ in range(5):
        state, out = train_step(state, batch)
        assert all(np.isfinite(float(v)) for v in out.values())
        losses.append(float(out["loss"]))
    assert losses[-1] < losses[0]
    assert state.step == 5 and state.tx.count == 5
    for a, p in zip(before, state.model.parameters()):
        assert not torch.equal(a, p.detach())


def test_short_finetune_serves_like_jax():
    """ROADMAP F2, decided at the tiny width: one ``from_flax`` state
    fine-tuned 4 steps at lr 1e-4 (the cyclic schedule over 4 steps peaks
    at 10 lr) by both packages on the same batches, then one frame served
    in eval mode by each.  Both serve finite boxes with the same mask of
    finite rows; losses at 1e-5 relative and served scores at 1e-4 (f32
    sums in another order over four steps)."""
    import dataclasses

    from geomae_tpu_torch.config import tiny_finetune_config as port_tiny

    def short(c):
        return dataclasses.replace(c, optim=dataclasses.replace(
            c.optim, lr=1e-4, total_steps=4))

    cj, ct = short(tiny_finetune_config()), short(port_tiny())
    params, stats = randomized_state(cj)
    jstate, tx = JFT.init_state(cj, 2, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=params, batch_stats=stats,
                            opt_state=tx.init(params))
    jstep = jax.jit(JFT.make_train_step(cj, tx))
    model = DynamicVoxelNet(ct)
    model.load_state_dict(from_flax(params, stats), strict=True)
    state = FT.TrainState(step=0, model=model, tx=AdamW(model, ct.optim))
    step = FT.make_train_step(ct)
    t = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    for i in range(4):
        batch = JFT.dummy_batch(cj, 2, seed=10 + i)
        jstate, jl = jstep(jstate, batch)
        state, tl = step(state, t(batch))
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]),
                                   rtol=1e-5)
    frame = JFT.dummy_batch(cj, 1, seed=99)
    frame = dict(points=frame["points"], point_valid=frame["point_valid"])
    want = jax.jit(JFT.make_predict_fn(cj))(jstate, frame)
    got = FT.make_predict_fn(ct)(state, t(frame))
    wv, gv = np.asarray(want.valid[0]), got.valid[0].numpy()
    wb, gb = np.asarray(want.boxes[0]), got.boxes[0].numpy()
    assert wv.any() and (wv == gv).all()
    assert np.isfinite(wb[wv]).all() and np.isfinite(gb[gv]).all()
    assert (np.isfinite(wb).all(-1) == np.isfinite(gb).all(-1)).all()
    np.testing.assert_allclose(got.scores[0].numpy()[gv],
                               np.asarray(want.scores[0])[wv], rtol=1e-4,
                               atol=1e-6)


def test_train_step_imports_no_jax():
    code = ("import sys, geomae_tpu_torch.train.finetune, "
            "geomae_tpu_torch.profile_train; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', "
            "'geomae_tpu') or m.startswith(('jax.', 'flax.', "
            "'geomae_tpu.'))]; "
            "sys.exit(str(bad) if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
