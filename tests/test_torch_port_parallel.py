"""Data parallelism of the port (``geomae_tpu_torch.parallel``): two gloo
ranks on the CPU, each a process joined through a ``FileStore``, against
one process on the whole batch and against the JAX step over a
two-device mesh.

One module fixture starts the two ranks (``rank_main``), which run every
two-rank case and save what they computed; meanwhile this process
computes the JAX step over ``make_mesh(2)`` and the one-process
references.  Each case is a function of the group (``None``: one process
on the whole batch), so both sides run the same code.  Batch 2, one row
a rank, at the tiny widths, f32."""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import geomae_tpu_torch.config as tcfg
from geomae_tpu_torch.data.loader import PrefetchLoader
from geomae_tpu_torch.data.synthetic import SyntheticSSL
from geomae_tpu_torch.models.anchor_head import assign_targets
from geomae_tpu_torch.models.anchors import grid_anchors, head_featmap_size
from geomae_tpu_torch.models.mae import GeoMAE, sample_mask
from geomae_tpu_torch.models.norm import MaskedBatchNorm
from geomae_tpu_torch.parallel import distributed as D
from geomae_tpu_torch.parallel.mesh import Group, init_distributed, shard_batch
from geomae_tpu_torch.train import checkpoint
from geomae_tpu_torch.train import finetune as FT
from geomae_tpu_torch.train import pretrain as PT
from geomae_tpu_torch.train.__main__ import main as train_main
from geomae_tpu_torch.train.optim import AdamW
from geomae_tpu_torch.train.state import TrainState
from geomae_tpu_torch.train.trainer import Trainer

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2
ULP = torch.finfo(torch.float32).eps


# ---------------------------------------------------------------------------
# the cases, each run by the ranks (a group) and by one process (None)
# ---------------------------------------------------------------------------


def rows(batch, group):
    return batch if group is None else shard_batch(batch, group.rank,
                                                   group.world)


def step_record(step, state, batch, *extra) -> dict:
    """One train step: its losses, the gradients it applied (summed over
    the ranks, after the clip, which scales them alike on both sides),
    and the state before and after."""
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, losses = step(state, batch, *extra)
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={k: p.grad.clone()
                       for k, p in state.model.named_parameters()},
                before=before, after=state.model.state_dict(),
                lr=state.tx.lr(0))


def pretrain_case(group) -> dict:
    cfg = tcfg.tiny_pretrain_config()
    state = PT.init_state(cfg, "cpu", torch.Generator().manual_seed(1))
    batch = PT.synthetic_batch(cfg, WORLD, seed=3, device="cpu")
    return step_record(PT.make_train_step(cfg, group), state,
                       rows(batch, group), torch.Generator().manual_seed(7))


FINETUNE_SEED = 4


def finetune_case(group) -> dict:
    cfg = tcfg.tiny_finetune_config()
    state = FT.init_state(cfg, "cpu", torch.Generator().manual_seed(1))
    batch = FT.synthetic_batch(cfg, WORLD, seed=FINETUNE_SEED, device="cpu")
    return step_record(FT.make_train_step(cfg, group), state,
                       rows(batch, group))


def center_case(group) -> dict:
    """The CenterHead's fine-tune step (``tiny_finetune_center_config()``):
    its heatmap and bbox loss denominators and its BN moments are whole-
    batch values."""
    cfg = tcfg.tiny_finetune_center_config()
    state = FT.init_state(cfg, "cpu", torch.Generator().manual_seed(1))
    batch = FT.synthetic_batch(cfg, WORLD, seed=FINETUNE_SEED, device="cpu")
    return step_record(FT.make_train_step(cfg, group), state,
                       rows(batch, group))


def bn_case(group) -> dict:
    """A MaskedBatchNorm in training mode, forward and backward; the
    second row's mask is all false."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(WORLD, 50, 8, generator=g) * 3 + 1
    mask = torch.rand(WORLD, 50, generator=g) < 0.6
    mask[1] = False
    cot = torch.randn(WORLD, 50, 8, generator=g)
    bn = MaskedBatchNorm(8)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
    r = slice(None) if group is None else slice(group.rank, group.rank + 1)
    xr = x[r].clone().requires_grad_()
    with D.data_parallel(group):
        y = bn(xr, mask[r])
    (y * cot[r]).sum().backward()
    D.all_reduce_grads(bn, group)
    return dict(y=y.detach(), dx=xr.grad, dweight=bn.weight.grad,
                dbias=bn.bias.grad, **{k: v.clone() for k, v in
                                       bn.state_dict().items()})


def gather_case(group) -> dict:
    local = [f"r{group.rank}.{i}" for i in range(group.rank + 1)]
    return dict(local=local, gathered=D.gather_results(local, group),
                mean=D.gather_scalar_mean(group.rank + 0.5, group))


class RankBatches:
    """A loader of the rank's rows of ``n`` global batches numbered from
    ``start`` (a resumed run continues where the first stopped)."""

    def __init__(self, cfg, n, start, group):
        self.cfg, self.n, self.start, self.group = cfg, n, start, group

    def __iter__(self):
        for i in range(self.start, self.start + self.n):
            yield {k: v.numpy() for k, v in rows(PT.synthetic_batch(
                self.cfg, WORLD, seed=i, device="cpu"), self.group).items()}


def eval_case(group) -> dict:
    """The pretrain eval hook over two global batches of 2."""
    cfg = tcfg.tiny_pretrain_config()
    state = PT.init_state(cfg, "cpu", torch.Generator().manual_seed(1))
    return PT.make_eval_hook(cfg, group)(state, list(RankBatches(
        cfg, 2, 20, group)))


def trainer_run(group, work, name, total, start, n) -> TrainState:
    """A Trainer of the tiny pretrain step on ``n`` global batches from
    ``start``, evaluating every 3 steps, checkpointing every step."""
    cfg = tcfg.tiny_pretrain_config()
    cfg = tcfg.replace(cfg, optim=tcfg.replace(cfg.optim, total_steps=6))
    state = PT.init_state(cfg, "cpu", torch.Generator().manual_seed(0))
    tr = Trainer(PT.make_train_step(cfg, group), state,
                 RankBatches(cfg, n, start, group), os.path.join(work, name),
                 total_steps=total, seed=5, log_interval=1, ckpt_interval=1,
                 eval_fn=PT.make_eval_hook(cfg, group),
                 eval_loader=list(RankBatches(cfg, 1, 20, group)),
                 eval_interval=3, group=group)
    return tr.run()


def trainer_case(group, work) -> dict:
    """3 steps, then resumed to 6, and an uninterrupted 6 steps; the
    checkpoint files this rank wrote."""
    writes = []
    write = checkpoint._write
    checkpoint._write = lambda obj, path: (writes.append(
        os.path.basename(path)), write(obj, path))
    try:
        trainer_run(group, work, "resumed", 3, 0, 3)
        resumed = trainer_run(group, work, "resumed", 6, 3, 3)
        whole = trainer_run(group, work, "whole", 6, 0, 6)
    finally:
        checkpoint._write = write
    tensors = lambda s: dict(s.model.state_dict(), step=torch.tensor(
        s.step), count=torch.tensor(s.tx.count), **{
        f"{m}.{i}": t for m in ("mu", "nu")
        for i, t in enumerate(getattr(s.tx, m))})
    return dict(resumed=tensors(resumed), whole=tensors(whole), writes=writes)


def jax_weights_case(group, work) -> dict:
    """The pretrain step from the JAX weights on the JAX keep mask, as the
    step's parts, to read the gradients before the clip."""
    path = os.path.join(work, "jax_inputs.pt")
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > 600:
            raise TimeoutError("no JAX inputs")
        time.sleep(0.2)
    inp = torch.load(path)
    cfg = tcfg.tiny_pretrain_config()
    model = GeoMAE(cfg)
    model.load_state_dict(inp["before"], strict=True)
    state = TrainState(step=0, model=model, tx=AdamW(model, cfg.optim))
    step = PT.make_train_step(cfg, group)
    batch = rows(dict(points=inp["points"], point_valid=inp["point_valid"],
                      keep=inp["keep"]), group)
    model.train()
    losses = step.loss_fn(model, batch, keep=batch["keep"])
    losses["loss"].backward()
    D.all_reduce_grads(model, group)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    state.tx.step()
    return dict(losses={k: float(v) for k, v in
                        D.sum_losses(losses, group).items()},
                grads=grads, after=model.state_dict(), lr=state.tx.lr(0))


def rank_main(rank: int, work: str) -> None:
    """One rank: join the group through a FileStore under ``work``, run
    every case, save the results as ``rank<r>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD))
    torch.set_num_threads(2)
    group = init_distributed("cpu", f"file://{work}/store")
    try:
        out = dict(group=(group.rank, group.world, str(group.device)),
                   bn=bn_case(group), gather=gather_case(group),
                   pretrain=pretrain_case(group),
                   finetune=finetune_case(group),
                   center=center_case(group),
                   eval=eval_case(group), trainer=trainer_case(group, work))
        out["jax"] = jax_weights_case(group, work)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# this process: the JAX step over a two-device mesh, the references
# ---------------------------------------------------------------------------


def jax_mesh_case(work: str) -> SimpleNamespace:
    """The JAX pretrain step jitted over ``make_mesh(2)`` (the conftest's
    virtual CPU devices) from randomized weights on clustered frames and
    a keep mask of the JAX sampler, as ``test_torch_port_pretrain_step``
    sets it up; the targets are computed once outside the mesh on the
    route the port takes (K3, K4 in interpret mode), so R1's
    mesh-dependent normals do not enter.  Writes the port's inputs for
    the ranks first."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import NamedSharding, PartitionSpec

    import geomae_tpu.config as jcfg
    from geomae_tpu.models import mae as jmae
    from geomae_tpu.ops.voxelize import build_scene_batch as jax_build
    from geomae_tpu.parallel.mesh import make_mesh
    from geomae_tpu.train.optim import make_optimizer
    from geomae_tpu_torch.weights import from_flax
    from test_torch_port_pretrain_ops import frames, randomized_geomae

    jc, tc = jcfg.tiny_pretrain_config(), tcfg.tiny_pretrain_config()
    params, stats = randomized_geomae(jc, seed=1)
    pts, valid = frames(tc, 3)
    scene = jax_build(jnp.asarray(pts), jnp.asarray(valid), jc.voxel,
                      jc.caps.max_voxels)
    keep = jmae.sample_mask(jax.random.PRNGKey(2), scene.table.valid,
                            jc.mae.random_mask_ratio)
    before = from_flax(params, stats)
    tmp = os.path.join(work, "jax_inputs.tmp")
    torch.save(dict(before=before, points=torch.from_numpy(pts),
                    point_valid=torch.from_numpy(valid),
                    keep=torch.from_numpy(np.array(keep))), tmp)
    os.replace(tmp, os.path.join(work, "jax_inputs.pt"))
    with pltpu.force_tpu_interpret_mode():
        targets = jmae.compute_targets_batch(scene, jc, use_pallas=True)
    net = jmae.GeoMAE(jc)
    tx = make_optimizer(jc.optim)

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

    mesh = make_mesh(WORLD)
    repl = NamedSharding(mesh, PartitionSpec())
    bsh = NamedSharding(mesh, PartitionSpec("data"))

    def put(tree, batched):
        return jax.tree_util.tree_map(lambda x: jax.device_put(
            x, bsh if batched and np.ndim(x) and x.shape[0] == WORLD
            else repl), tree)

    losses, grads, new_stats, new_params = jax.jit(jax_step)(
        put(params, False), put(stats, False), put(scene, True),
        put(targets, True), put(keep, True))
    assert len(losses["loss"].sharding.device_set) == WORLD
    return SimpleNamespace(losses={k: float(v) for k, v in losses.items()},
                           grads=from_flax(grads, {}), before=before,
                           after=from_flax(new_params, new_stats))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    procs, logs = [], []
    for r in range(WORLD):
        logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import test_torch_port_parallel as t; "
             f"t.rank_main({r}, {work!r})"], cwd=REPO, env=env,
            stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        jax_side = jax_mesh_case(work)
        refs = dict(pretrain=pretrain_case(None),
                    finetune=finetune_case(None), center=center_case(None),
                    bn=bn_case(None), eval=eval_case(None))
        trainer_run(None, work, "one_process", 6, 0, 6)
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"rank{r}.log")) as f:
            assert p.returncode == 0, f.read()[-3000:]
    got = [torch.load(os.path.join(work, f"rank{r}.pt"))
           for r in range(WORLD)]
    return SimpleNamespace(work=work, ranks=got, refs=refs, jax=jax_side)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def assert_ranks_bitwise_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_ranks_bitwise_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def assert_updates_agree(before, after, want_after, grads, want_grads, lr,
                         sel_tol=1e-3, any_tol=2.001):
    """The sign-agreement rule of ``chip_smoke.compare_step``: AdamW's
    first update is about lr * sign(g), so where the reference gradient
    exceeds a tenth of its tensor's rms and the two gradients agree in
    sign, the updates agree to ``sel_tol`` lr; elsewhere to ``any_tol``
    lr (a sign flipped by rounding).  Both beyond two f32 ulps of the
    weight (each side rounds the updated weight once).  The selection
    must hold most elements."""
    n_sel = n_all = 0
    for k, want in want_after.items():
        if "running_" in k or k.endswith("num_batches_tracked"):
            continue
        d = ((after[k] - before[k]) - (want - before[k])).abs() / lr
        d = d - 2 * ULP * before[k].abs() / lr
        g, gw = grads[k], want_grads[k]
        sel = (gw.abs() > 0.1 * gw.square().mean().sqrt()) \
            & (g.sign() == gw.sign())
        n_sel, n_all = n_sel + int(sel.sum()), n_all + sel.numel()
        assert float(d[sel].max() if sel.any() else 0) <= sel_tol, k
        assert float(d.max()) <= any_tol, k
    assert n_sel > 0.5 * n_all, (n_sel, n_all)


def assert_grads_close(grads, want, tol):
    for k, g in want.items():
        err = float((grads[k] - g).norm() / g.norm().clamp_min(1e-30))
        assert err <= tol, (k, err)


def assert_buffers_close(after, want_after, rtol, atol, n_expected):
    n = 0
    for k, want in want_after.items():
        if k.endswith("num_batches_tracked"):
            assert int(after[k]) == 1, k      # JAX counts no updates
        elif "running_" in k:
            np.testing.assert_allclose(after[k].numpy(), want.numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)
            n += 1
    assert n == n_expected


def test_two_rank_pretrain_step_equals_one_process(ranks):
    """Two ranks, one row each, mask rows of one draw, against one process
    on the batch of 2: losses at 2e-5 relative and gradients at 1e-5
    relative norm (f32 sums split over two ranks, in another order), BN
    running statistics at 2e-4 relative (the bound of
    ``test_mesh_equivalence``), parameters by the sign-agreement rule;
    the ranks bitwise equal."""
    a, b = (r["pretrain"] for r in ranks.ranks)
    assert_ranks_bitwise_equal(a, b, "pretrain")
    want = ranks.refs["pretrain"]
    assert a["losses"].keys() == want["losses"].keys()
    for k, v in want["losses"].items():
        np.testing.assert_allclose(a["losses"][k], v, rtol=2e-5, err_msg=k)
    assert_grads_close(a["grads"], want["grads"], 1e-5)
    assert_buffers_close(a["after"], want["after"], 2e-4, 1e-5, 4)
    assert_updates_agree(a["before"], a["after"], want["after"], a["grads"],
                         want["grads"], want["lr"])


def test_two_rank_pretrain_step_matches_jax_over_a_two_device_mesh(ranks):
    """The same two-rank step from the JAX weights on the JAX keep mask
    against the JAX step over a two-device mesh, at
    ``test_torch_port_pretrain_step``'s bounds: losses 1e-5 relative,
    gradients 1e-4 relative norm, BN statistics 1e-5 + 1e-4 relative,
    parameters by its rule (1e-3 lr where |g| exceeds a tenth of the rms
    and 1e-6, 2 lr elsewhere, two ulps)."""
    a, b = (r["jax"] for r in ranks.ranks)
    assert_ranks_bitwise_equal(a, b, "jax")
    want = ranks.jax
    assert a["losses"].keys() == want.losses.keys()
    for k, v in want.losses.items():
        np.testing.assert_allclose(a["losses"][k], v, rtol=1e-5, err_msg=k)
    assert_grads_close(a["grads"], want.grads, 1e-4)
    assert_buffers_close(a["after"], want.after, 1e-4, 1e-5, 4)
    n_sel = 0
    for k, w in want.after.items():
        if "running_" in k or k.endswith("num_batches_tracked"):
            continue
        d = ((a["after"][k] - want.before[k]) - (w - want.before[k])).abs()
        d = d / a["lr"] - 2 * ULP * want.before[k].abs() / a["lr"]
        g = want.grads[k].abs()
        sel = (g > 0.1 * g.square().mean().sqrt()) & (g > 1e-6)
        n_sel += int(sel.sum())
        assert float(d[sel].max() if sel.any() else 0) <= 1e-3, k
        assert float(d.max()) <= 2.001, k
    assert n_sel > 0.5 * sum(v.numel() for k, v in want.grads.items())


def test_two_rank_finetune_step_equals_one_process(ranks):
    """The fine-tune step, two ranks against one process, on a batch whose
    rows hold different numbers of positive anchors (so a per-rank
    ``num_pos`` would differ): losses at 2e-5 relative, gradients at 1e-5
    relative norm, BN statistics at 2e-4 relative, parameters by the
    sign-agreement rule; the ranks bitwise equal."""
    cfg = tcfg.tiny_finetune_config()
    batch = FT.synthetic_batch(cfg, WORLD, seed=FINETUNE_SEED, device="cpu")
    anchors = torch.from_numpy(grid_anchors(cfg.head, head_featmap_size(cfg)))
    pos = [int(assign_targets(anchors, *(batch[k][i] for k in (
        "gt_boxes", "gt_labels", "gt_mask")), cfg.head).num_pos)
        for i in range(WORLD)]
    assert pos[0] != pos[1] and min(pos) > 0, pos
    a, b = (r["finetune"] for r in ranks.ranks)
    assert_ranks_bitwise_equal(a, b, "finetune")
    want = ranks.refs["finetune"]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(a["losses"][k], v, rtol=2e-5, err_msg=k)
    assert_grads_close(a["grads"], want["grads"], 1e-5)
    n_bn = sum(k.endswith("running_mean") for k in want["after"])
    assert_buffers_close(a["after"], want["after"], 2e-4, 1e-5, 2 * n_bn)
    assert_updates_agree(a["before"], a["after"], want["after"], a["grads"],
                         want["grads"], want["lr"])


def test_two_rank_centerhead_step_equals_one_process(ranks):
    """The CenterHead's fine-tune step, two ranks against one process, on
    a batch whose rows hold different numbers of each task's objects and
    peak pixels (so a per-rank heatmap or bbox count would differ):
    losses at 2e-5 relative, gradients at 1e-5 relative norm, BN
    statistics (the head's 37 among them) at 2e-4 relative, parameters
    by the sign-agreement rule; the ranks bitwise equal."""
    from geomae_tpu_torch.models.center_head import compute_center_targets

    cfg = tcfg.tiny_finetune_center_config()
    batch = FT.synthetic_batch(cfg, WORLD, seed=FINETUNE_SEED, device="cpu")
    tg = compute_center_targets(batch["gt_boxes"], batch["gt_labels"],
                                batch["gt_mask"], cfg.center_head, cfg.voxel,
                                (10, 10))
    peaks = (tg.heatmap == 1).sum((1, 2, 3)).tolist()
    first = tg.mask & (tg.cls == 0)              # the first task's objects
    objs = first.sum(1).tolist()
    assert peaks[0] != peaks[1] and objs[0] != objs[1], (peaks, objs)
    a, b = (r["center"] for r in ranks.ranks)
    assert_ranks_bitwise_equal(a, b, "center")
    want = ranks.refs["center"]
    assert len(want["losses"]) == 13
    for k, v in want["losses"].items():
        np.testing.assert_allclose(a["losses"][k], v, rtol=2e-5, err_msg=k)
    assert_grads_close(a["grads"], want["grads"], 1e-5)
    n_bn = sum(k.endswith("running_mean") for k in want["after"])
    assert n_bn == 2 + 4 + 2 + 37          # VFE, SECOND, FPN, head
    assert_buffers_close(a["after"], want["after"], 2e-4, 1e-5, 2 * n_bn)
    assert_updates_agree(a["before"], a["after"], want["after"], a["grads"],
                         want["grads"], want["lr"])


def test_masked_batch_norm_over_two_ranks_equals_the_whole_batch(ranks):
    """Each rank's output and input gradient are its rows of the whole
    batch's, the parameter gradients summed over the ranks and the
    running statistics are the whole batch's (f32 sums of 30-50 rows in
    another order: 1e-5 relative), though one rank's mask is all
    false; the running statistics bitwise equal on both ranks."""
    want = ranks.refs["bn"]
    a, b = (r["bn"] for r in ranks.ranks)
    for k in ("running_mean", "running_var", "num_batches_tracked",
              "weight", "bias", "dweight", "dbias"):
        assert torch.equal(a[k], b[k]), k
        np.testing.assert_allclose(a[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for r, got in enumerate((a, b)):
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k].numpy(), want[k][r:r + 1],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(b["dx"].abs().max()) > 0     # the masked-out rank's rows


def test_gather_results_and_scalar_mean(ranks):
    """Lists of unequal lengths come back rank-major on every rank, as the
    JAX function concatenates its processes' lists; the scalar mean is
    the mean over the ranks; without a group both are the identity, as
    the JAX functions are in one process."""
    from geomae_tpu.parallel import distributed as jdist

    lists = [r["gather"]["local"] for r in ranks.ranks]
    assert [len(x) for x in lists] == [1, 2]
    for r in ranks.ranks:
        assert r["gather"]["gathered"] == lists[0] + lists[1]
        assert r["gather"]["mean"] == 1.0
    assert D.gather_results(lists[1], None) == jdist.gather_results(lists[1])
    assert D.gather_scalar_mean(2.5, None) == jdist.gather_scalar_mean(2.5)


def test_two_rank_eval_hook_equals_one_process(ranks):
    """The pretrain eval hook on two ranks, each on its rows of two global
    batches, gives one process's means over the whole batches: each rank
    draws its rows of the whole batch's mask and divides by the whole
    batch's counts, and the terms are summed over the ranks.  2e-5
    relative, as the train step's losses; the ranks bitwise equal."""
    a, b = (r["eval"] for r in ranks.ranks)
    assert a == b
    want = ranks.refs["eval"]
    assert a.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(a[k], v, rtol=2e-5, err_msg=k)


def val_rows(work, name):
    with open(os.path.join(work, name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "iter_time"}
            for r in rows if r["mode"] == "val"]


def test_two_rank_trainer_resume_equals_an_uninterrupted_run(ranks):
    """A two-rank Trainer run 3 steps, then resumed to 6 on the same work
    dir, equals an uninterrupted 6 steps bitwise, on each rank, and the
    ranks equal each other; rank 0 alone wrote checkpoints and logs (one
    train row a step in ``metrics.jsonl``, one resume line).  Its eval
    rows, at steps 3 and 6, equal the uninterrupted run's and hold to a
    one-process Trainer's on the whole batches at 2e-5 relative, as the
    step's losses (measured: 3.3e-7 at most)."""
    a, b = (r["trainer"] for r in ranks.ranks)
    for r in (a, b):
        assert_ranks_bitwise_equal(r["resumed"], r["whole"], "trainer")
    assert_ranks_bitwise_equal(a["resumed"], b["resumed"], "ranks")
    assert int(a["resumed"]["step"]) == 6
    assert a["writes"] == ["1.pt", "2.pt", "3.pt", "4.pt", "5.pt", "6.pt",
                           "1.pt", "2.pt", "3.pt", "4.pt", "5.pt", "6.pt"]
    assert b["writes"] == []
    with open(os.path.join(ranks.work, "resumed", "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f
                if '"train"' in line] == [1, 2, 3, 4, 5, 6]
    got = val_rows(ranks.work, "resumed")
    assert [r["step"] for r in got] == [3, 6]
    assert got == val_rows(ranks.work, "whole")
    want = val_rows(ranks.work, "one_process")
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w.keys() - {"step", "mode"}:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=k)
    with open(os.path.join(ranks.work, "resumed", "train.log")) as f:
        assert f.read().count("resumed from step 3") == 1
    assert ranks.ranks[0]["group"] == (0, 2, "cpu")
    assert ranks.ranks[1]["group"] == (1, 2, "cpu")


def test_rank_rows_of_the_mask_and_the_loader():
    """Each rank's rows of ``sample_mask`` (from a generator in the same
    state) and of the ``PrefetchLoader`` (synchronous and with workers)
    equal its rows of the whole batch's; ``shard_batch`` cuts the same
    rows and refuses a batch that does not divide."""
    g = torch.Generator().manual_seed(0)
    valid = torch.rand(4, 300, generator=g) < 0.7
    whole = sample_mask(torch.Generator().manual_seed(9), valid, 0.7)
    for r in range(WORLD):
        grp = Group(rank=r, world=WORLD, device=torch.device("cpu"))
        with D.data_parallel(grp):
            mine = sample_mask(torch.Generator().manual_seed(9),
                               valid[2 * r:2 * r + 2], 0.7)
        assert torch.equal(mine, whole[2 * r:2 * r + 2])
    with D.data_parallel(None):
        assert torch.equal(sample_mask(torch.Generator().manual_seed(9),
                                       valid, 0.7), whole)

    ds = SyntheticSSL(tcfg.tiny_pretrain_config(), n=10)
    for workers in (0, 2):
        want = list(PrefetchLoader(ds, 4, num_workers=workers, seed=3))
        got = [list(PrefetchLoader(ds, 4, num_workers=workers, seed=3,
                                   rank=r, world=WORLD))
               for r in range(WORLD)]
        assert len(want) == 2 and all(len(x) == 2 for x in got)
        for i, w in enumerate(want):
            for r in range(WORLD):
                cut = shard_batch(w, r, WORLD)
                assert all(np.array_equal(got[r][i][k], cut[k]) for k in w)
                assert all(np.array_equal(cut[k], w[k][2 * r:2 * r + 2])
                           for k in w)
    with pytest.raises(ValueError, match="does not divide"):
        PrefetchLoader(ds, 3, rank=0, world=WORLD)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": np.zeros((3, 1))}, 0, WORLD)


def test_cli_global_batch_must_divide(monkeypatch, tmp_path):
    """Under ``torchrun`` the CLI's ``--batch-size`` is the global batch;
    one that does not divide over the ranks raises before any process
    group starts."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        train_main(["pretrain", "--synthetic", "--tiny", "--device", "cpu",
                    "--batch-size", "3", "--total-steps", "1",
                    "--work-dir", str(tmp_path)])
    assert not dist.is_initialized()
