"""F2 at full width: the phase-H fine-tune (4 steps at the config's lr
1e-4 on a 4-step cyclic schedule, which peaks at 10 x lr) then one frame
served in eval mode, by both packages on the CPU in f32, from the same
weights and the same seeded ``synthetic_batch``es, batch 1.

The model is ``geomae_finetune_nus()`` at its widths, depths, BEV grid
and pillar cap; the point cap is cut to 16,384 (the scenes are drawn at
that cap) and the box slots to 64 (the scenes hold 60 boxes).  Slow:
both packages' full-width steps on the CPU, about 5 minutes and 19 GiB
of host memory at its peak for each init, most of it the JAX side.

Two inits, each carried into the other package: the port's training
init, ``finetune.init_state`` (``init_weights_reference``: the JAX
initializer's distributions, drawn by torch), and the JAX package's own
initializer (LeCun-normal kernels, zero biases).  From either, neither
package may serve a non-finite box.  The port's serving init
``init_weights`` (He-uniform weights, non-zero biases), which the
training entry points started from before, made both packages serve
non-finite boxes here (ROADMAP F2, repaired)."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import geomae_tpu.config as jcfg
import geomae_tpu_torch.config as tcfg
from geomae_tpu.train import finetune as JFT
from geomae_tpu.train.torch_import import import_torch_weights
from geomae_tpu_torch.models.detector import DynamicVoxelNet
from geomae_tpu_torch.train import finetune as FT
from geomae_tpu_torch.train.optim import AdamW
from geomae_tpu_torch.weights import from_flax

STEPS = 4


def phase_h_config(C):
    cfg = C.geomae_finetune_nus()
    return dataclasses.replace(
        cfg, compute_dtype="float32", max_gt_boxes=64,
        caps=dataclasses.replace(cfg.caps, max_points=16384),
        optim=dataclasses.replace(cfg.optim, lr=1e-4, total_steps=STEPS))


@pytest.mark.slow
@pytest.mark.parametrize("init", ["port", "jax"])
def test_full_width_finetune_serves_alike_in_both_packages(init):
    """Neither package serves a non-finite box, from either init.  The
    first step's loss agrees at 1e-5 relative (f32 sums in another
    order); later steps drift apart, as AdamW moves every
    weight by about lr x sign(g) and a gradient within rounding of 0
    takes either sign (measured from the JAX init: 2.4e-7, 1.2e-5,
    2.2e-4, 6.8e-3 relative over the four steps), so they are held to be
    finite only."""
    t0 = time.perf_counter()
    cj, ct = phase_h_config(jcfg), phase_h_config(tcfg)
    jstate, tx = JFT.init_state(cj, 1, jax.random.PRNGKey(0))
    if init == "port":
        state = FT.init_state(ct, "cpu", torch.Generator().manual_seed(0))
        sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
        params, stats, report = import_torch_weights(
            jstate.params, jstate.batch_stats, sd, "finetune")
        assert report["missing"] == [] and report["unconsumed"] == []
        jstate = jstate.replace(params=params, batch_stats=stats,
                                opt_state=tx.init(params))
    else:
        model = DynamicVoxelNet(ct)
        model.load_state_dict(from_flax(jstate.params, jstate.batch_stats),
                              strict=True)
        model.train()
        state = FT.TrainState(step=0, model=model, tx=AdamW(model, ct.optim))
    jstep = jax.jit(JFT.make_train_step(cj, tx))
    step = FT.make_train_step(ct)
    losses = []
    for i in range(STEPS):
        batch = FT.synthetic_batch(ct, 1, seed=10 + i, device="cpu")
        jstate, jl = jstep(jstate, {k: v.numpy() for k, v in batch.items()})
        state, tl = step(state, batch)
        losses.append((float(jl["loss"]), float(tl["loss"])))
        print(f"step {i}: loss JAX {losses[-1][0]:.6f}, port "
              f"{losses[-1][1]:.6f} ({time.perf_counter() - t0:.0f} s)")
    frame = FT.synthetic_batch(ct, 1, seed=99, device="cpu")
    frame = dict(points=frame["points"], point_valid=frame["point_valid"])
    want = jax.jit(JFT.make_predict_fn(cj))(
        jstate, {k: v.numpy() for k, v in frame.items()})
    got = FT.make_predict_fn(ct)(state, frame)
    served = {}
    for name, boxes, valid in (
            ("JAX", np.asarray(want.boxes[0]), np.asarray(want.valid[0])),
            ("port", got.boxes[0].numpy(), got.valid[0].numpy())):
        bad = ~np.isfinite(boxes[valid])
        served[name] = (int(valid.sum()), int(bad.any(-1).sum()),
                        sorted({int(c) for c in np.nonzero(bad)[1]}))
        print(f"{name}: {served[name][0]} valid boxes, {served[name][1]} "
              f"with a non-finite value, in columns {served[name][2]}")
    print(f"wall {time.perf_counter() - t0:.0f} s")
    np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=1e-5)
    assert np.isfinite(losses).all()
    assert served["JAX"][1] == served["port"][1] == 0, served
