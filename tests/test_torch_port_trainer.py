"""The port's trainer entry point on the CPU at the tiny configs:
``load_pretrained`` against the JAX package's through ``from_flax``;
checkpoints (bitwise round trip, retention, the path forms of
``load_weights``); the ``Trainer`` (resume equals an uninterrupted run
bitwise, the eval hook's schedule, an empty loader); the loader; the CLI
(pretrain, then fine-tune from its checkpoint, then serving from the
fine-tune checkpoint; the same from info files on disk, nuScenes with CBGS
and Waymo; the CenterHead preset); the training init against the JAX
initializer's distributions (the anchor and the CenterHead detectors,
GeoMAE); and the tiny pretrain step on the ``band`` attention route
against the JAX step on its einsum route."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geomae_tpu.config as jcfg
import geomae_tpu_torch.config as tcfg
from geomae_tpu.data.loader import PrefetchLoader as JaxLoader
from geomae_tpu.data.synthetic import synthetic_scene as jax_scene
from geomae_tpu.models import mae as jmae
from geomae_tpu.ops.voxelize import build_scene_batch as jax_build
from geomae_tpu.train import finetune as JFT
from geomae_tpu.train import pretrain as JPT
from geomae_tpu_torch.apis import inference_detector, init_model
from geomae_tpu_torch.data.loader import PrefetchLoader
from geomae_tpu_torch.data.nuscenes import (CBGSDataset, NuScenesDetDataset,
                                            NuScenesSSLDataset)
from geomae_tpu_torch.data.synthetic import (SyntheticDet, SyntheticSSL,
                                             synthetic_scene,
                                             write_synthetic_infos)
from geomae_tpu_torch.data.waymo import WaymoDataset, WaymoSSLDataset
from geomae_tpu_torch.models.detector import DynamicVoxelNet
from geomae_tpu_torch.models.mae import GeoMAE
from geomae_tpu_torch.train import finetune as FT
from geomae_tpu_torch.train import pretrain as PT
from geomae_tpu_torch.train.__main__ import main as train_main
from geomae_tpu_torch.train.checkpoint import (CheckpointManager,
                                               load_weights, save_weights)
from geomae_tpu_torch.train.trainer import Trainer
from geomae_tpu_torch.utils.logging import collect_env
from geomae_tpu_torch.weights import from_flax
from test_torch_port_data import write_waymo_infos
from test_torch_port_pretrain_ops import frames, randomized_geomae
from test_torch_port_weights import randomized_state


def state_tensors(state):
    out = dict(state.model.state_dict())
    for key, ts in (("mu", state.tx.mu), ("nu", state.tx.nu)):
        out.update({f"{key}.{i}": a for i, a in enumerate(ts)})
    return out


def assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, differ[:5]
    assert (a.step, a.tx.count) == (b.step, b.tx.count)


# ---------------------------------------------------------------------------
# load_pretrained
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    det = randomized_state(jcfg.tiny_finetune_config(), seed=2)
    geo = randomized_geomae(jcfg.tiny_pretrain_config(), seed=3)
    return det, geo


def test_load_pretrained_matches_jax(trees):
    """The JAX ``load_pretrained`` result carried through ``from_flax``
    equals the port's ``load_pretrained`` on the two carried
    ``state_dict``s, tensor for tensor; every VFE and encoder-block
    parameter is imported and nothing else."""
    (det_p, det_s), (geo_p, geo_s) = trees
    want = from_flax(JFT.load_pretrained(det_p, geo_p), det_s)
    model = DynamicVoxelNet(tcfg.tiny_finetune_config())
    model.load_state_dict(from_flax(det_p, det_s), strict=True)
    names = FT.load_pretrained(model, from_flax(geo_p, geo_s))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    shared = [k for k, _ in model.named_parameters() if k.startswith(
        ("voxel_encoder.", "backbone.encoder_blocks."))]
    assert sorted(names) == sorted(shared) and len(names) > 0
    before = from_flax(det_p, det_s)
    assert all(not torch.equal(got[k], before[k]) for k in names)


def test_load_pretrained_skips_shapes_and_needs_a_match(trees):
    (det_p, det_s), (geo_p, geo_s) = trees
    model = DynamicVoxelNet(tcfg.tiny_finetune_config())
    geo = from_flax(geo_p, geo_s)
    odd = "voxel_encoder.vfe_layers.0.linear.weight"
    before = model.state_dict()[odd].clone()
    geo[odd] = geo[odd][:, :-1]                    # a wrong shape: skipped
    names = FT.load_pretrained(model, geo)
    assert odd not in names and len(names) > 0
    assert torch.equal(model.state_dict()[odd], before)
    with pytest.raises(ValueError, match="no pretrained weights"):
        FT.load_pretrained(model, {"backbone.mask_token": geo[
            "backbone.mask_token"]})
    state = FT.init_state(tcfg.tiny_finetune_config(), "cpu",
                          pretrain=from_flax(geo_p, geo_s))
    key = "backbone.encoder_blocks.0.encoder_list.0.linear1.weight"
    assert torch.equal(state.model.state_dict()[key],
                       from_flax(geo_p, geo_s)[key])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def trained_state(cfg, steps, seed=0):
    state = PT.init_state(cfg, "cpu", torch.Generator().manual_seed(seed))
    step = PT.make_train_step(cfg)
    for i in range(steps):
        step(state, PT.synthetic_batch(cfg, 2, seed=i, device="cpu"),
             torch.Generator().manual_seed(i))
    return state


def test_checkpoint_round_trip_retention_and_path_forms(tmp_path):
    """A saved state restores bitwise into a fresh one (model, moments,
    update count, step); ``save`` follows the interval unless forced and
    keeps the newest three; ``load_weights`` takes a weights file, the
    checkpoint directory (latest step) and one step's file."""
    cfg = tcfg.tiny_pretrain_config()
    state = trained_state(cfg, 2)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    assert mgr.save(state) and not mgr.save(state)       # once per step
    fresh = PT.init_state(cfg, "cpu", torch.Generator().manual_seed(9))
    assert_states_equal(mgr.restore(fresh), state)

    first = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = PT.make_train_step(cfg)
    for i in range(2, 7):
        step(state, PT.synthetic_batch(cfg, 2, seed=i, device="cpu"),
             torch.Generator().manual_seed(i))
        wrote = mgr.save(state, force=(i == 6))
        assert wrote == (state.step % 2 == 0 or i == 6)
    assert mgr.all_steps() == [4, 6, 7] and mgr.latest_step() == 7

    latest = state.model.state_dict()
    for path in (str(tmp_path / "ckpt"), mgr.path(7)):
        got = load_weights(path, "cpu")
        assert all(torch.equal(got[k], v) for k, v in latest.items())
    got4 = load_weights(mgr.path(4), "cpu")
    assert any(not torch.equal(got4[k], v) for k, v in latest.items())
    save_weights(str(tmp_path / "export" / "w.pt"), first)
    got = load_weights(str(tmp_path / "export" / "w.pt"), "cpu")
    assert all(torch.equal(got[k], v) for k, v in first.items())
    torch.save(first, str(tmp_path / "bare.pt"))         # a bare state_dict
    got = load_weights(str(tmp_path / "bare.pt"), "cpu")
    assert got.keys() == first.keys()
    with pytest.raises(FileNotFoundError):
        load_weights(str(tmp_path / "export"), "cpu")    # no step files


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class Batches:
    """A loader of ``n`` fixed batches, numbered from ``start`` (a resumed
    run continues where the first stopped)."""

    def __init__(self, cfg, n, start=0):
        self.cfg, self.n, self.start = cfg, n, start

    def __iter__(self):
        for i in range(self.start, self.start + self.n):
            yield {k: v.numpy() for k, v in PT.synthetic_batch(
                self.cfg, 2, seed=i, device="cpu").items()}


def make_trainer(cfg, work_dir, total, loader, **kw):
    state = PT.init_state(cfg, "cpu", torch.Generator().manual_seed(0))
    return Trainer(PT.make_train_step(cfg), state, loader, str(work_dir),
                   total_steps=total, seed=5, log_interval=1, **kw)


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    """3 steps, then a second trainer on the same work dir resumes at 3
    and runs to 5: its state equals a 5-step run's bitwise (the mask of
    step s is seeded from (seed, s), the optimizer's moments and update
    count come back from the checkpoint)."""
    cfg = tcfg.tiny_pretrain_config()
    cfg = tcfg.replace(cfg, optim=tcfg.replace(cfg.optim, total_steps=5))
    tr = make_trainer(cfg, tmp_path / "a", 3, Batches(cfg, 4), ckpt_interval=1)
    assert tr.run().step == 3
    assert os.path.exists(tmp_path / "a" / "train.log")
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(r["mode"] == "train" and np.isfinite(r["loss"]) for r in rows)
    assert len(tr.timings["step"]) == 3

    tr2 = make_trainer(cfg, tmp_path / "a", 5, Batches(cfg, 4, start=3),
                       ckpt_interval=1)
    assert tr2.state.step == 3
    assert_states_equal(tr2.state, tr.state)
    with open(tmp_path / "a" / "train.log") as f:
        assert "resumed from step 3" in f.read()
    whole = make_trainer(cfg, tmp_path / "b", 5, Batches(cfg, 8))
    assert_states_equal(tr2.run(), whole.run())
    assert tr2.ckpt.all_steps() == [3, 4, 5]
    assert whole.ckpt.all_steps() == [5]              # the forced last save
    fresh = make_trainer(cfg, tmp_path / "a", 5, Batches(cfg, 1), resume=False)
    assert fresh.state.step == 0


def test_trainer_eval_hook_schedule_and_empty_loader(tmp_path):
    """``eval_interval=2`` over 5 steps: the hook fires at 2, 4 and at the
    end (5), with finite losses in ``val`` rows; the model is back in
    training mode.  A loader that yields nothing raises."""
    cfg = tcfg.tiny_pretrain_config()
    hook, calls = PT.make_eval_hook(cfg), []

    def eval_fn(state, loader):
        calls.append((state.step, hook(state, loader)))
        return calls[-1][1]

    eval_batches = list(Batches(cfg, 1, start=99))
    tr = make_trainer(cfg, tmp_path / "e", 5, Batches(cfg, 8),
                      ckpt_interval=100, eval_fn=eval_fn,
                      eval_loader=eval_batches, eval_interval=2)
    tr.run()
    assert [s for s, _ in calls] == [2, 4, 5]
    assert all(len(c) == 7 and np.isfinite(c["loss"]) for _, c in calls)
    assert tr.state.model.training
    with open(tmp_path / "e" / "metrics.jsonl") as f:
        modes = [json.loads(line)["mode"] for line in f]
    assert modes.count("val") == 3 and modes.count("train") == 5
    # the same state and batches give the same metric: a fixed mask
    assert hook(tr.state, eval_batches) == calls[-1][1]

    empty = make_trainer(cfg, tmp_path / "n", 2, [])
    with pytest.raises(RuntimeError, match="no batches"):
        empty.run()


def test_loader_and_synthetic_scenes_match_jax():
    """``synthetic_scene`` and the ``PrefetchLoader`` (order, per-sample
    seeds, epochs) against the JAX package's, bitwise, with worker threads
    and without."""
    r = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    for a, b in zip(synthetic_scene(np.random.default_rng(3), r, 4000),
                    jax_scene(np.random.default_rng(3), r, 4000)):
        assert np.array_equal(a, b)
    cfg = tcfg.tiny_finetune_config()
    ds = SyntheticDet(cfg, n=10)
    assert set(ds[0]) == {"points", "point_valid", "gt_boxes", "gt_labels",
                          "gt_mask"}
    assert set(SyntheticSSL(cfg)[0]) == {"points", "point_valid"}
    for workers in (0, 3):
        mine = PrefetchLoader(ds, 4, num_workers=workers, seed=7)
        ref = JaxLoader(ds, 4, num_workers=0, seed=7)
        assert len(mine) == len(ref) == 2
        for _ in range(2):                             # two epochs
            for a, b in zip(list(mine), list(ref)):
                assert a.keys() == b.keys()
                assert all(np.array_equal(a[k], b[k]) for k in a)

    class Broken(SyntheticDet):
        def __getitem__(self, idx, seed=None):
            raise KeyError("broken sample")

    with pytest.raises(KeyError):
        list(PrefetchLoader(Broken(cfg, n=8), 4, num_workers=2))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_pretrain_then_finetune_then_serve(tmp_path):
    """``python -m geomae_tpu_torch.train`` in process, tiny, on the CPU,
    band route: pretrain 2 steps, fine-tune 2 steps from its checkpoint
    (the log reports the import), then ``init_model`` from the fine-tune
    checkpoint serves the fine-tuned weights."""
    pre, ft = str(tmp_path / "pre"), str(tmp_path / "ft")
    common = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "2",
              "--num-workers", "2", "--total-steps", "2", "--cfg-options",
              "sst.attention_impl=band"]
    tr = train_main(["pretrain", "--work-dir", pre, "--eval-interval", "2",
                     "--eval-frames", "2", *common])
    assert tr.state.step == 2 and isinstance(tr.state.model, GeoMAE)
    # at the tiny width (32 in 4 heads) every attention_impl resolves to
    # the plain band attention, as in the JAX package
    assert tr.state.model.backbone.encoder_blocks[0].encoder_list[0] \
        .win_attn.route == "einsum"
    with open(os.path.join(pre, "metrics.jsonl")) as f:
        assert [json.loads(line)["mode"] for line in f] == ["val"]
    tr2 = train_main(["finetune", "--work-dir", ft, "--load-from",
                      os.path.join(pre, "ckpt"), *common])
    assert tr2.state.step == 2 and tr2.ckpt.all_steps() == [2]
    with open(os.path.join(ft, "train.log")) as f:
        log = f.read()
    assert "imported 54/87 pretrained tensors" in log
    assert "training done at step 2" in log
    det = init_model(checkpoint=os.path.join(ft, "ckpt"),
                     cfg=tr2.state.model.cfg, device="cpu")
    want = tr2.state.model.state_dict()
    assert all(torch.equal(v, want[k])
               for k, v in det.model.state_dict().items())
    assert not det.model.training


def test_cli_unported_paths_raise(tmp_path):
    """Once the unported CenterHead preset, which raised; now it trains:
    ``--preset nus_centerhead --tiny`` fine-tunes 2 synthetic steps of
    ``tiny_finetune_center_config()`` with finite per-task losses and a
    checkpoint."""
    from geomae_tpu_torch.models.center_head import CenterHead

    tr = train_main(["finetune", "--synthetic", "--preset", "nus_centerhead",
                     "--tiny", "--device", "cpu", "--batch-size", "2",
                     "--num-workers", "0", "--total-steps", "2",
                     "--log-interval", "1", "--work-dir",
                     str(tmp_path / "ft")])
    tiny = tcfg.tiny_finetune_center_config()
    assert tr.state.model.cfg == tcfg.replace(tiny, optim=tcfg.replace(
        tiny.optim, total_steps=2))
    assert isinstance(tr.state.model.bbox_head, CenterHead)
    assert tr.state.step == 2 and tr.ckpt.all_steps() == [2]
    with open(tmp_path / "ft" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2 and all(
        len(r) >= 13 and np.isfinite(r["loss"]) and
        np.isfinite(r["task5.loss_bbox"]) for r in rows)


def test_cli_from_disk_pretrain_then_cbgs_finetune_then_serve(tmp_path):
    """The CLI on nuScenes infos on disk (``write_synthetic_infos``: 20
    frames, all boxes cars): pretrain 2 steps on ``NuScenesSSLDataset``
    (the native point prep), fine-tune 2 steps with ``--cbgs`` from that
    checkpoint (a one-class set keeps int(0.1 n) = 2 rows, one batch),
    then serve a test-mode frame of the same files from the fine-tune
    checkpoint: finite boxes."""
    root = str(tmp_path / "nus")
    write_synthetic_infos(root, n_frames=20, n_points=4000, n_sweeps=2)
    pre, ft = str(tmp_path / "pre"), str(tmp_path / "ft")
    common = ["--tiny", "--device", "cpu", "--batch-size", "2",
              "--num-workers", "2", "--total-steps", "2", "--data-root",
              root, "--ann-file", "infos.pkl", "--log-interval", "1"]
    tr = train_main(["pretrain", "--work-dir", pre, *common])
    assert isinstance(tr.loader.dataset, NuScenesSSLDataset)
    assert tr.loader.dataset.native and len(tr.loader.dataset) == 20
    tr2 = train_main(["finetune", "--cbgs", "--work-dir", ft, "--load-from",
                      os.path.join(pre, "ckpt"), *common])
    ds = tr2.loader.dataset
    assert isinstance(ds, CBGSDataset) and len(ds) == 2
    assert tr2.state.step == 2 and tr2.ckpt.all_steps() == [2]
    for d in (pre, ft):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    with open(os.path.join(ft, "train.log")) as f:
        assert "imported 54/87 pretrained tensors" in f.read()
    cfg = tr2.state.model.cfg
    assert cfg.data.data_root == root
    det = init_model(checkpoint=os.path.join(ft, "ckpt"), cfg=cfg,
                     device="cpu")
    frame = NuScenesDetDataset(cfg.data, cfg.voxel, cfg.caps, test_mode=True)
    pts = frame[3]["points"][frame[3]["point_valid"]]
    res = inference_detector(det, pts)
    assert np.isfinite(res["boxes"]).all() and res["boxes"].shape[1] == 9
    # without --cbgs a --tiny fine-tune reads every frame
    tr3 = train_main(["finetune", "--work-dir", str(tmp_path / "ft2"),
                      *common])
    assert isinstance(tr3.loader.dataset, NuScenesDetDataset)


def test_cli_waymo_pretrain_from_disk_then_resume(tmp_path):
    """``--preset waymo`` reads KITTI-format Waymo infos
    (``WaymoSSLDataset``, 6-channel frames, pose-relative sweeps) at the
    tiny Waymo geometry; a second run resumes; a fine-tune from it reads
    ``WaymoDataset``."""
    root = str(tmp_path / "waymo")
    ann = write_waymo_infos(root, n_frames=4)
    work = str(tmp_path / "pre")
    common = ["pretrain", "--preset", "waymo", "--tiny", "--device", "cpu",
              "--batch-size", "2", "--num-workers", "0", "--data-root", root,
              "--ann-file", ann, "--work-dir", work]
    tr = train_main([*common, "--total-steps", "2"])
    assert isinstance(tr.loader.dataset, WaymoSSLDataset)
    cfg = tr.state.model.cfg
    assert cfg.voxel == tcfg.tiny_pretrain_waymo_config().voxel
    assert (tr.loader.dataset.load_dims, tr.loader.dataset.use_dims) == (6, 5)
    tr2 = train_main([*common, "--total-steps", "3"])
    assert tr2.state.step == 3
    with open(os.path.join(work, "train.log")) as f:
        assert "resumed from step 2" in f.read()
    # fine-tune on the same infos (WaymoDataset, on the nuScenes fine-tune
    # config as in tools/train.py; its frames have 6 channels)
    tr3 = train_main(["finetune", "--preset", "waymo", "--tiny", "--device",
                      "cpu", "--batch-size", "2", "--num-workers", "0",
                      "--data-root", root, "--ann-file", ann, "--work-dir",
                      str(tmp_path / "ft"), "--total-steps", "1",
                      "--load-from", os.path.join(work, "ckpt"),
                      "--cfg-options", "data.load_dim=6"])
    assert isinstance(tr3.loader.dataset, WaymoDataset)
    assert tr3.state.step == 1


@pytest.mark.parametrize("preset,root", [("nus", "data/nuscenes"),
                                         ("waymo", "data/waymo")])
def test_cli_data_root_defaults_to_the_config(tmp_path, preset, root):
    """Without ``--data-root`` the preset's own root is read (the JAX CLI
    would read data/nuscenes for every preset)."""
    with pytest.raises(FileNotFoundError, match=root):
        train_main(["pretrain", "--preset", preset, "--tiny", "--device",
                    "cpu", "--work-dir", str(tmp_path)])


PRESETS = {"finetune": "geomae_finetune_nus", "pretrain": "geomae_pretrain_nus",
           "center": "geomae_finetune_nus_centerhead"}


@pytest.mark.parametrize("task", ["finetune", "pretrain", "center"])
def test_training_init_draws_the_jax_initializers_distributions(task):
    """``init_state``'s weights (``init_weights_reference``) against the
    JAX package's initializer, tensor by tensor, at the full widths of
    ``geomae_finetune_nus()`` / ``geomae_pretrain_nus()`` /
    ``geomae_finetune_nus_centerhead()`` (the pillar grid and caps cut:
    no parameter's shape depends on them).  A tensor
    that JAX sets to a constant (biases, norms, BN statistics) equals it
    bitwise; a tensor of 4,096 entries or more has a std within 5 % of
    the JAX draw's, and its largest |w| at its family's bound (the
    uniform families' bound, 2 / 0.8796 std for LeCun's truncated
    normal), read from the JAX draw's own largest |w|, within 2 %."""
    def cut(C):
        cfg = getattr(C, PRESETS[task])()
        h = 32 * cfg.voxel.voxel_size[0]              # a 64 x 64 grid
        return C.replace(
            cfg, voxel=C.replace(cfg.voxel, point_cloud_range=(
                -h, -h, -5.0, h, h, 3.0)),
            caps=C.replace(cfg.caps, max_points=1024, max_voxels=256,
                           max_visible=128), compute_dtype="float32")

    jc, tc = cut(jcfg), cut(tcfg)
    jstate, _ = (JPT if task == "pretrain" else JFT).init_state(
        jc, 1, jax.random.PRNGKey(0))
    want = from_flax(jstate.params, jstate.batch_stats)
    state = (PT if task == "pretrain" else FT).init_state(
        tc, "cpu", torch.Generator().manual_seed(0))
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    n_big = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.numel() == 1 or bool((w == w.flatten()[0]).all()):
            assert torch.equal(g, w), k
            continue
        assert w.numel() >= 128, k        # every drawn tensor is large
        if w.numel() < 4096:
            continue
        n_big += 1
        ratio = float(g.float().std() / w.float().std())
        assert abs(ratio - 1) < 0.05, (k, ratio)
        # the family's bound: at 4,096 draws or more the largest |w| of
        # either package lies within 1 % of it (a uniform of the same std
        # as LeCun's truncated normal stops at 0.76 of its bound)
        top = float(g.abs().max()) / float(w.abs().max())
        assert abs(top - 1) < 0.02, (k, top)
    # the detector: 12 SST layers x 4, 16 SECOND convs, 3 FPN ups, 3 head
    # convs, a VFE Linear; GeoMAE: 12 + 8 SST layers x 4, a VFE Linear, 4
    # heads; the CenterHead detector: 12 SST layers x 4, 10 SECOND convs,
    # 2 FPN levels, the shared conv, the first conv of 6 tasks x 6 branches
    # (their final convs, 576-1,152 entries, are drawn too, and below the
    # size read here), a VFE Linear
    assert n_big == {"finetune": 71, "pretrain": 85, "center": 98}[task]


def test_predict_fn_and_collect_env():
    cfg = tcfg.tiny_finetune_config()
    state = FT.init_state(cfg, "cpu")
    batch = FT.synthetic_batch(cfg, 2, device="cpu")
    det = FT.make_predict_fn(cfg)(state, batch)
    assert det.boxes.shape[0] == 2 and det.boxes.shape[-1] == 9
    assert state.model.training
    wn = FT.make_predict_fn(cfg, wnms=True)(state, batch)
    assert wn.boxes.shape == (2, cfg.head.max_num, 9)
    assert wn.scores.shape == wn.labels.shape == wn.valid.shape \
        == (2, cfg.head.max_num)
    assert wn.valid.any() and bool((wn.scores[wn.valid] > 0).all())
    assert bool((wn.scores[~wn.valid] == -1).all())
    env = collect_env()
    assert env["torch"] == torch.__version__ and "devices" in env


# ---------------------------------------------------------------------------
# the pretrain step on the band route
# ---------------------------------------------------------------------------


def test_band_route_pretrain_losses_match_jax():
    """The tiny pretrain step's seven losses on the port's ``band`` route
    (K8's plain version here) against the JAX forward with
    ``attention_impl="einsum"``, same weights, points and keep mask:
    1e-5 relative (f32 means over the masked rows in another order)."""
    jc = jcfg.tiny_pretrain_config()
    jc = jcfg.replace(jc, sst=jcfg.replace(jc.sst, attention_impl="einsum"))
    tc = tcfg.apply_overrides(tcfg.tiny_pretrain_config(),
                              ["sst.attention_impl=band"])
    params, stats = randomized_geomae(jc, seed=4)
    pts, valid = frames(tc, 5)
    scene = jax_build(jnp.asarray(pts), jnp.asarray(valid), jc.voxel,
                      jc.caps.max_voxels)
    keep = jmae.sample_mask(jax.random.PRNGKey(6), scene.table.valid,
                            jc.mae.random_mask_ratio)
    targets = jmae.compute_targets_batch(scene, jc, use_pallas=False)
    net = jmae.GeoMAE(jc)

    @jax.jit
    def jax_losses(p, s, sc, tg, k):
        preds, _ = net.apply({"params": p, "batch_stats": s}, sc, k,
                             train=True, mutable=["batch_stats"])
        return jmae.pretrain_loss(preds, tg, sc, k, jc)

    want = jax_losses(params, stats, scene, targets, keep)
    model = GeoMAE(tc)
    model.load_state_dict(from_flax(params, stats), strict=True)
    model.train()
    got = PT.make_train_step(tc).loss_fn(
        model, dict(points=torch.from_numpy(pts),
                    point_valid=torch.from_numpy(valid)),
        keep=torch.from_numpy(np.array(keep)))
    assert set(got) == set(want) and len(got) == 7
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
