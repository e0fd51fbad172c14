"""The port's CenterHead (``geomae_tpu_torch.models.center_head``) and its
NMS (``ops/rotated_iou.py``: ``nms_bev``, ``circle_nms``) against the
JAX package's, f32, on the CPU, on the same seeded numpy inputs: the
gaussian radius and targets (at ``tiny_finetune_center_config()`` and at
the full preset's 100 x 100 map with 512 GT slots), the loss, the decode
(on random logits and on planted ties), both NMS functions, the module
from ``from_flax`` weights in train and eval BN modes, the whole tiny
fine-tune step, the predict function, and the CLI's ``--preset
nus_centerhead`` from info files on disk, then serving from its
checkpoint."""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import geomae_tpu.config as jcfg
import geomae_tpu_torch.config as tcfg
from geomae_tpu.models import center_head as JCH
from geomae_tpu.models.detector import DynamicVoxelNet as JaxNet
from geomae_tpu.ops import rotated_iou as JR
from geomae_tpu.train import finetune as JFT
from geomae_tpu.train.optim import make_optimizer
from geomae_tpu.train.state import TrainState as JaxState
from geomae_tpu_torch.apis import inference_detector, init_model
from geomae_tpu_torch.data.nuscenes import NuScenesDetDataset
from geomae_tpu_torch.data.synthetic import write_synthetic_infos
from geomae_tpu_torch.models import center_head as CH
from geomae_tpu_torch.models.detector import DynamicVoxelNet
from geomae_tpu_torch.ops import rotated_iou as R
from geomae_tpu_torch.train import finetune as FT
from geomae_tpu_torch.train.__main__ import main as train_main
from geomae_tpu_torch.train.optim import AdamW
from geomae_tpu_torch.weights import from_flax
from test_torch_port_weights import randomized_state

TINY = jcfg.tiny_finetune_center_config()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU ops: the tier-1 run puts six
    test processes on the machine's cores, and torch's default of a
    thread a core oversubscribes them (its small ops then wait on their
    thread pools)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS = ("reg", "height", "dim", "rot", "vel", "heatmap")


def random_gt(rng, cfg, B, G, n_valid):
    """GT boxes [B, G, 9] over the config's range and a little past it (so
    some centres fall off the map and some land at x in (-1, 0) pixels),
    car- to cone-sized, labels over every class, the first ``n_valid``
    slots set."""
    r = cfg.voxel.point_cloud_range
    boxes = np.zeros((B, G, 9), np.float32)
    boxes[..., 0] = rng.uniform(r[0] - 1.5, r[3] + 1.0, (B, G))
    boxes[..., 1] = rng.uniform(r[1] - 1.0, r[4] + 1.0, (B, G))
    boxes[..., 2] = rng.uniform(-2.0, 0.0, (B, G))
    boxes[..., 3:6] = rng.uniform(0.3, 5.0, (B, G, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    boxes[..., 7:9] = rng.normal(0, 1, (B, G, 2))
    # x just below the range start: cx in (-1, 0), truncated to pixel 0
    vx = cfg.voxel.voxel_size[0] * cfg.center_head.out_size_factor
    boxes[:, 0, 0] = r[0] - 0.4 * vx
    boxes[:, 0, 1] = 0.0                   # a pixel edge of either map
    labels = rng.integers(0, cfg.center_head.num_classes,
                          (B, G)).astype(np.int32)
    mask = np.zeros((B, G), bool)
    mask[:, :n_valid] = True
    return boxes, labels, mask


def jax_targets(boxes, labels, mask, cfg, featmap):
    fn = jax.jit(jax.vmap(lambda b, l, m: JCH.compute_center_targets(
        b, l, m, cfg.center_head, cfg.voxel, featmap)))
    return fn(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))


def port_targets(boxes, labels, mask, cfg, featmap):
    return CH.compute_center_targets(
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask), cfg.center_head, cfg.voxel, featmap)


def test_gaussian_radius_matches_jax():
    """The halved-roots radius on random box sizes (0.1 to 20 pixels),
    overlap 0.1: 1e-6 relative."""
    rng = np.random.default_rng(0)
    l, w = rng.uniform(0.1, 20, (2, 1000)).astype(np.float32)
    want = np.asarray(JCH.gaussian_radius_feat(jnp.asarray(l), jnp.asarray(w),
                                               0.1))
    got = CH.gaussian_radius_feat(torch.from_numpy(l), torch.from_numpy(w),
                                  0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("preset,B,G,n_valid", [
    ("tiny", 3, 32, 24), ("full", 1, 512, 400)])
def test_center_targets_match_jax(preset, B, G, n_valid):
    """``compute_center_targets`` for the whole batch against the JAX
    function under ``vmap``: the tiny preset's 10 x 10 map, and the full
    preset's 100 x 100 map with 512 GT slots.  Heatmap and anno to 1e-6
    absolute (the same f32 operations; ``exp`` may round apart by an
    ulp), inds, mask and classes exactly; the truncated pixel-0 centre
    and off-map centres among them, and a centre at y = 0.0 m, which true
    f32 division puts on a pixel edge and XLA, multiplying by the f32
    reciprocal of the voxel size, just below it (the port's ``_div``)."""
    cfg = TINY if preset == "tiny" else jcfg.geomae_finetune_nus_centerhead()
    H = cfg.voxel.grid_size[0] // cfg.center_head.out_size_factor
    featmap = (H, H)
    boxes, labels, mask = random_gt(np.random.default_rng(1), cfg, B, G,
                                    n_valid)
    want = jax_targets(boxes, labels, mask, cfg, featmap)
    got = port_targets(boxes, labels, mask, cfg, featmap)
    assert got.heatmap.shape == (B, cfg.center_head.num_classes, H, H)
    np.testing.assert_allclose(got.heatmap.numpy(), np.asarray(want.heatmap),
                               atol=1e-6)
    np.testing.assert_allclose(got.anno.numpy(), np.asarray(want.anno),
                               atol=1e-6)
    for f in ("inds", "mask", "cls"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    m = got.mask.numpy()
    assert m[:, 0].all() and (got.inds.numpy()[:, 0] % H == 0).all()
    assert 0 < m.sum() < B * n_valid
    assert (got.heatmap == 1.0).sum() > 0


def random_preds(rng, cfg, B, H, W, scale=1.0):
    """Random head outputs: per task, NHWC numpy arrays by head name."""
    ch = cfg.center_head
    sizes = dict(ch.common_heads)
    out = []
    for t in ch.tasks:
        sizes["heatmap"] = len(t)
        out.append({k: (rng.normal(0, scale, (B, H, W, n)) - (
            2.0 if k == "heatmap" else 0.0)).astype(np.float32)
            for k, n in sizes.items()})
    return out


def nchw(preds):
    return [{k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous()
             for k, v in p.items()} for p in preds]


def test_center_head_loss_matches_jax():
    """``center_head_loss`` on the same random head outputs and GT: every
    task's heatmap and bbox loss at 1e-5 relative (f32 sums over the
    map in another order)."""
    rng = np.random.default_rng(2)
    B, H = 2, 10
    boxes, labels, mask = random_gt(rng, TINY, B, 32, 20)
    preds = random_preds(rng, TINY, B, H, H)
    want = jax.jit(lambda *a: JCH.center_head_loss(
        *a, TINY.center_head, TINY.voxel))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    got = CH.center_head_loss(nchw(preds), torch.from_numpy(boxes),
                              torch.from_numpy(labels),
                              torch.from_numpy(mask), TINY.center_head,
                              TINY.voxel)
    assert set(got) == set(want) and len(got) == 12
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    assert all(float(v) > 0 for v in got.values())


def jax_decode_task(p):
    return jax.jit(lambda q: JCH.decode_task(q, TINY.center_head,
                                             TINY.voxel))(
        {k: jnp.asarray(v) for k, v in p.items()})


def jax_decode(preds):
    return jax.jit(lambda q: JCH.center_head_decode(q, TINY.center_head,
                                                    TINY.voxel))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds])


def assert_no_pair_near(boxes5, thr, tol=1e-5):
    """The test's precondition: no pair's IoU within ``tol`` of ``thr``,
    so rounding cannot flip a suppression."""
    b = torch.as_tensor(np.asarray(boxes5)).reshape(-1, boxes5.shape[-2], 5)
    iou = R.boxes_iou_bev_batched(b)
    assert not bool(((iou - thr).abs() < tol).any())


def test_decode_matches_jax():
    """``decode_task`` per task and ``center_head_decode`` on random logits
    (batch 2, tiny preset): the selected pixels and classes exactly, the
    boxes to 1e-5; the decoded detections' valid rows and labels exactly,
    their scores and boxes to 1e-5 (inputs checked to hold no IoU near
    the NMS threshold)."""
    rng = np.random.default_rng(3)
    B, H = 2, 10
    preds = random_preds(rng, TINY, B, H, H, scale=2.0)
    ch = TINY.center_head
    tp = nchw(preds)
    for ti, p in enumerate(preds):
        got = CH.decode_task(tp[ti], ch, TINY.voxel)
        for b in range(B):
            want = jax_decode_task({k: v[b] for k, v in p.items()})
            np.testing.assert_allclose(got[0][b].numpy(),
                                       np.asarray(want[0]), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got[1][b].numpy(),
                                       np.asarray(want[1]), rtol=1e-6)
            assert np.array_equal(got[2][b].numpy(), np.asarray(want[2]))
            assert np.array_equal(got[3][b].numpy(), np.asarray(want[3]))
            assert_no_pair_near(got[0][b][:, [0, 1, 3, 4, 6]][None],
                                ch.nms_thr)
    want = jax_decode(preds)
    got = CH.center_head_decode(tp, ch, TINY.voxel)
    v = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), v) and v.sum() > 4
    assert np.array_equal(got.labels.numpy()[v], np.asarray(want.labels)[v])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], rtol=1e-5,
                               atol=1e-5)
    assert got.labels.dtype == torch.int32


def test_decode_picks_jax_pixels_among_ties():
    """A heatmap of equal logits (a flat empty region) with a few peaks
    and a band of equal second values: ``decode_task`` selects the
    pixels ``lax.top_k`` selects, in its order (lower index first among
    equal values), and ``center_head_decode``'s final top-k over the
    many -1.0 scores of suppressed rows agrees too."""
    rng = np.random.default_rng(4)
    B, H = 1, 10
    preds = random_preds(rng, TINY, B, H, H)
    for ti, p in enumerate(preds):
        # equal logits below the score threshold everywhere, two peaks a
        # task, and in the first task 20 equal values above it: 32
        # candidates pass the threshold, at most 16 a task the NMS, so
        # the final top 32 reaches into the -1.0 scores
        hm = np.full(p["heatmap"].shape, -3.0, np.float32)
        hm[0, 2, 3, 0] = hm[0, 7, 1, -1] = 1.0
        if ti == 0:
            hm[0, 4:6, :, :] = 0.5
        p["heatmap"] = hm
    ch = TINY.center_head
    tp = nchw(preds)
    for ti, p in enumerate(preds):
        flat = np.moveaxis(p["heatmap"][0], -1, 0).reshape(-1)
        _, want_idx = jax.lax.top_k(jax.nn.sigmoid(jnp.asarray(flat)),
                                    ch.topk)
        want = jax_decode_task({k: v[0] for k, v in p.items()})
        got = CH.decode_task(tp[ti], ch, TINY.voxel)
        sig = torch.sigmoid(torch.from_numpy(flat))
        assert np.array_equal(torch.sort(sig, descending=True,
                                         stable=True)[1][:ch.topk].numpy(),
                              np.asarray(want_idx))
        np.testing.assert_allclose(got[0][0].numpy()[:, :2],
                                   np.asarray(want[0])[:, :2], atol=1e-5)
        assert np.array_equal(got[2][0].numpy(), np.asarray(want[2]))
    want = jax_decode(preds)
    got = CH.center_head_decode(tp, ch, TINY.voxel)
    assert (np.asarray(want.scores) == -1.0).sum() >= 6
    for f in ("valid", "labels", "scores"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-5)


def test_nms_bev_and_circle_nms_match_jax():
    """Both greedy NMS functions on random score-sorted candidates (three
    rankings of 64, crowded so that many suppress, 80 % valid), all
    rankings in one call of the port's batched functions against the
    JAX function per ranking: the keep masks equal, with a threshold per
    ranking, and with ``max_out`` cutting the list.  No IoU (distance)
    lies within 1e-5 of its threshold."""
    rng = np.random.default_rng(5)
    N, K = 3, 64
    boxes = np.concatenate([rng.uniform(-4, 4, (N, K, 2)),
                            rng.uniform(0.5, 3, (N, K, 2)),
                            rng.uniform(-np.pi, np.pi, (N, K, 1))],
                           -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (N, K)), -1).astype(np.float32)
    valid = rng.uniform(0, 1, (N, K)) < 0.8
    thr = (0.2, 0.1, 0.35)
    for t in thr:
        assert_no_pair_near(boxes, t)
    for max_out in (K, 10):
        got = R.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(valid), list(thr), max_out).numpy()
        one = R.nms_bev(torch.from_numpy(boxes[0]),
                        torch.from_numpy(scores[0]),
                        torch.from_numpy(valid[0]), thr[0], max_out).numpy()
        for n in range(N):
            want = np.asarray(JR.nms_bev(jnp.asarray(boxes[n]),
                                         jnp.asarray(scores[n]),
                                         jnp.asarray(valid[n]), thr[n],
                                         max_out))
            assert np.array_equal(got[n], want), (n, max_out)
        assert np.array_equal(one, got[0])
        assert got.sum(-1).max() <= max_out and not got[~valid].any()
    assert got.sum() < valid.sum()                   # some suppressed
    centers = boxes[..., :2]
    d = np.sqrt(((centers[:, :, None] - centers[:, None]) ** 2).sum(-1))
    assert not (np.abs(d - 0.8) < 1e-5).any()
    got = R.circle_nms(torch.from_numpy(centers), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.8, 20).numpy()
    for n in range(N):
        want = np.asarray(JR.circle_nms(jnp.asarray(centers[n]),
                                        jnp.asarray(scores[n]),
                                        jnp.asarray(valid[n]), 0.8, 20))
        assert np.array_equal(got[n], want), n
    assert 0 < got.sum() < valid.sum()


# ---------------------------------------------------------------------------
# the module, the step, predict
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    params, stats = randomized_state(TINY, seed=3)
    return params, stats


def head_state_dict(params, stats):
    sd = from_flax({"bbox_head": params["bbox_head"]},
                   {"bbox_head": stats["bbox_head"]})
    return {k[len("bbox_head."):]: v for k, v in sd.items()}


def test_center_head_module_matches_flax(weights):
    """The ``CenterHead`` module with ``from_flax`` weights (strictly
    loaded, under the reference's names) against the flax module on one
    random [2, 64, 10, 10] map: every task's every output at 1e-5, in
    eval mode (running statistics) and in training mode (batch
    statistics), and the running statistics after the training
    forward."""
    params, stats = weights
    ch = TINY.center_head
    x = np.random.default_rng(6).normal(0, 1, (2, 10, 10, ch.in_channels)
                                        ).astype(np.float32)
    net = JCH.CenterHead(ch)
    variables = {"params": params["bbox_head"],
                 "batch_stats": stats["bbox_head"]}
    head = CH.CenterHead(ch)
    sd = head_state_dict(params, stats)
    head.load_state_dict(sd, strict=True)
    assert "task_heads.5.heatmap.1.bias" in sd
    assert "shared_conv.bn.running_var" in sd
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    for train in (False, True):
        if train:
            want, mut = net.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        else:
            want = net.apply(variables, jnp.asarray(x), train=False)
        head.train(train)
        with torch.no_grad():
            got = head(xt)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert tuple(g) == HEADS
            for k in HEADS:
                np.testing.assert_allclose(
                    g[k].permute(0, 2, 3, 1).numpy(), np.asarray(w[k]),
                    rtol=1e-5, atol=1e-5, err_msg=f"{k} train={train}")
    after = head_state_dict(params, {"bbox_head": mut["batch_stats"]})
    for k, v in head.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), after[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def step(weights):
    """One compiled JAX CenterHead step and the port's from the same state
    and batch (as ``test_torch_port_train_step``), and both predict
    functions on one more frame from the updated states."""
    params, stats = weights
    cfg = TINY
    # seed 5, as test_torch_port_train_step.  At seed 7 one point's second
    # VFE pre-activation lies 1.6e-5 from the ReLU's kink, inside the two
    # packages' forward difference on its row (5e-5 after the batch norm's
    # f32 moments), so the ReLU passes its gradient in one package only
    # and the VFE's parameter gradients part by 3e-3 relative norm: the
    # step is discontinuous there, as the NMS is at its threshold
    batch = JFT.dummy_batch(cfg, 2, seed=5)
    net = JaxNet(cfg)
    tx = make_optimizer(cfg.optim)

    @jax.jit
    def jax_step(p, s, b):
        def loss_fn(p_):
            scene = JFT.extract_scene(cfg, b["points"], b["point_valid"])
            out, mut = net.apply({"params": p_, "batch_stats": s}, scene,
                                 train=True, mutable=["batch_stats"])
            losses = JCH.center_head_loss(out, b["gt_boxes"], b["gt_labels"],
                                          b["gt_mask"], cfg.center_head,
                                          cfg.voxel)
            losses["loss"] = sum(losses.values())
            return losses["loss"], (losses, mut["batch_stats"])

        (_, (losses, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        upd, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, new_stats, optax.apply_updates(p, upd)

    losses, grads, new_stats, new_params = jax_step(params, stats, batch)

    tc = tcfg.tiny_finetune_center_config()
    model = DynamicVoxelNet(tc)
    before = from_flax(params, stats)
    model.load_state_dict(before, strict=True)
    state = FT.TrainState(step=0, model=model, tx=AdamW(model, tc.optim))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    model.train()
    got = FT.make_train_step(tc).loss_fn(model, tb)
    got["loss"].backward()
    port_grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    state.tx.step()

    frame = JFT.dummy_batch(cfg, 1, seed=8)
    frame = dict(points=frame["points"], point_valid=frame["point_valid"])
    jstate = JaxState(step=0, params=new_params, batch_stats=new_stats,
                      opt_state=None)
    want_det = jax.jit(JFT.make_predict_fn(cfg))(jstate, frame)
    got_det = FT.make_predict_fn(tc)(state, {
        k: torch.from_numpy(np.array(v)) for k, v in frame.items()})
    return SimpleNamespace(
        losses=losses, grads=from_flax(grads, {}),
        after=from_flax(new_params, new_stats), before=before,
        port_losses={k: float(v.detach()) for k, v in got.items()},
        port_grads=port_grads, port_after=model.state_dict(),
        lr=state.tx.lr(0), model=model, want_det=want_det, got_det=got_det)


def test_center_step_losses_and_gradients_match_jax(step):
    """The 12 loss terms and their sum at 1e-5 relative; every parameter's
    gradient at 1e-4 relative norm (``test_torch_port_train_step``'s
    rules)."""
    assert set(step.port_losses) == set(step.losses) and \
        len(step.losses) == 13
    for k, v in step.port_losses.items():
        np.testing.assert_allclose(v, float(step.losses[k]), rtol=1e-5,
                                   err_msg=k)
    assert set(step.grads) == set(step.port_grads)
    zero = []
    for k, g in step.grads.items():
        err = float((step.port_grads[k] - g).norm()
                    / g.norm().clamp_min(1e-30))
        assert err <= 1e-4, (k, err)
        zero += [k] if not g.any() else []
    # a task without objects in the batch: its regression branches have
    # no loss term, so exactly zero gradients in both packages
    assert all(".task_heads." in k for k in zero)


def test_center_step_update_and_batch_statistics_match_jax(step):
    """After the update: where |g| exceeds a tenth of its tensor's rms the
    parameters' updates agree to 1e-3 lr, elsewhere to 2 lr (a sign
    flipped by rounding); the running statistics at 1e-5 + 1e-4
    relative, every BN of the model, the head's 37 among them."""
    n_sel = n_bn = 0
    for k, want in step.after.items():
        if k.endswith("num_batches_tracked"):
            assert int(step.port_after[k]) == 1, k
        elif "running_" in k:
            np.testing.assert_allclose(step.port_after[k].numpy(),
                                       want.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            n_bn += 1
        else:
            d = ((step.port_after[k] - step.before[k])
                 - (want - step.before[k])).abs() / step.lr
            g = step.grads[k].abs()
            sel = g > 0.1 * g.square().mean().sqrt()
            n_sel += int(sel.sum())
            assert float(d[sel].max() if sel.any() else 0) <= 1e-3, k
            assert float(d.max()) <= 2.001, k
    assert n_sel > 0.7 * sum(p.numel() for p in step.model.parameters())
    n_head_bn = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                    for m in step.model.bbox_head.modules())
    assert n_head_bn == 1 + 6 * 6
    assert n_bn == 2 * sum(isinstance(
        m, torch.nn.modules.batchnorm._BatchNorm)
        for m in step.model.modules())


def test_center_predict_fn_matches_jax(step):
    """``make_predict_fn`` from the updated states on one more frame: the
    same valid rows and labels, scores at 1e-4 relative and boxes at 1e-4
    (f32 sums of a whole model in another order, after one update); the
    weighted-NMS path refuses the CenterHead, as in the JAX package."""
    want, got = step.want_det, step.got_det
    v = np.asarray(want.valid)[0]
    assert v.any() and np.array_equal(got.valid[0].numpy(), v)
    assert np.array_equal(got.labels[0].numpy()[v],
                          np.asarray(want.labels)[0][v])
    np.testing.assert_allclose(got.scores[0].numpy()[v],
                               np.asarray(want.scores)[0][v], rtol=1e-4)
    np.testing.assert_allclose(got.boxes[0].numpy()[v],
                               np.asarray(want.boxes)[0][v], rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="anchor head only"):
        FT.make_predict_fn(tcfg.tiny_finetune_center_config(), wnms=True)


def test_per_task_nms_thresholds():
    """A tuple ``nms_thr`` of the wrong length raises, as in the JAX
    package; with thresholds of zero no two kept boxes of one task
    overlap, where the default 0.2 keeps overlapping ones."""
    tc = tcfg.tiny_finetune_center_config()
    preds = nchw(random_preds(np.random.default_rng(9), TINY, 1, 10, 10,
                              scale=2.0))
    with pytest.raises(ValueError, match="one threshold per task"):
        CH.center_head_decode(preds, tcfg.replace(
            tc.center_head, nms_thr=(0.2, 0.2)), tc.voxel)
    task = np.repeat(np.arange(6), [len(t) for t in tc.center_head.tasks])

    def overlaps(det):
        v = det.valid[0]
        b = det.boxes[0][v][:, [0, 1, 3, 4, 6]]
        t = torch.from_numpy(task)[det.labels[0][v].long()]
        iou = R.boxes_iou_bev(b, b).fill_diagonal_(0)
        return int(((iou > 0) & (t[:, None] == t[None])).sum())

    zero = CH.center_head_decode(preds, tcfg.replace(
        tc.center_head, nms_thr=(0.0,) * 6), tc.voxel)
    base = CH.center_head_decode(preds, tc.center_head, tc.voxel)
    assert overlaps(zero) == 0 < overlaps(base)


def test_cli_centerhead_from_disk_then_serve(tmp_path):
    """``--preset nus_centerhead --tiny --device cpu`` fine-tunes 2 steps
    on nuScenes infos on disk (``write_synthetic_infos``), with finite
    per-task losses; ``init_model`` then serves a test-mode frame of the
    same files from its checkpoint: the CenterHead's weights, finite
    boxes, at most ``topk`` of them, labels in [0, 10), scores above the
    threshold."""
    root = str(tmp_path / "nus")
    write_synthetic_infos(root, n_frames=8, n_points=4000, n_sweeps=2)
    ft = str(tmp_path / "ft")
    tr = train_main(["finetune", "--preset", "nus_centerhead", "--tiny",
                     "--device", "cpu", "--batch-size", "2", "--num-workers",
                     "2", "--total-steps", "2", "--data-root", root,
                     "--ann-file", "infos.pkl", "--log-interval", "1",
                     "--work-dir", ft])
    cfg = tr.state.model.cfg
    assert cfg.head_type == "center" and tr.state.step == 2
    assert isinstance(tr.state.model.bbox_head, CH.CenterHead)
    assert isinstance(tr.loader.dataset, NuScenesDetDataset)
    with open(os.path.join(ft, "metrics.jsonl")) as f:
        rows = f.read()
    assert "task5.loss_heatmap" in rows
    det = init_model(checkpoint=os.path.join(ft, "ckpt"), cfg=cfg,
                     device="cpu")
    want = tr.state.model.state_dict()
    assert all(torch.equal(v, want[k])
               for k, v in det.model.state_dict().items())
    frame = NuScenesDetDataset(cfg.data, cfg.voxel, cfg.caps,
                               test_mode=True)[2]
    res = inference_detector(det, frame["points"][frame["point_valid"]])
    n = len(res["scores"])
    assert res["boxes"].shape == (n, 9) and np.isfinite(res["boxes"]).all()
    assert n <= cfg.center_head.topk
    assert ((res["labels"] >= 0) & (res["labels"] < 10)).all()
    assert (res["scores"] > cfg.center_head.score_threshold).all()
