"""The port's evaluation and serving extras against the JAX package's, on
the CPU, on the same seeded numpy inputs: the nuScenes, KITTI (AP_R40 and
the reference's 11-point AP) and Waymo evaluators and the results JSON,
on random predictions and on the ground truth scored as its own
prediction; weighted NMS (``core/wnms.py``) and the anchor head's
weighted-NMS prediction (``decode_pre_nms``, ``predict_wnms``); the
test-time-augmentation merge and ``Detector3D.aug_test``; and the eval
CLI ``python -m geomae_tpu_torch.test`` in process, after a tiny
fine-tune, on nuScenes infos (hard and weighted NMS, ``--out``) and on a
KITTI-format Waymo tree (``--dataset kitti`` and ``waymo``), its metrics
held to ``geomae_tpu``'s evaluators on the port's own predictions."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geomae_tpu.config as jcfg
import geomae_tpu_torch.config as tcfg
from geomae_tpu import apis as japis
from geomae_tpu.core import aug_merge as jaug
from geomae_tpu.core import wnms as jwnms
from geomae_tpu.eval import kitti_eval as jkitti
from geomae_tpu.eval import nuscenes_eval as jnus
from geomae_tpu.eval import waymo_eval as jwaymo
from geomae_tpu.models import anchor_head as JAH
from geomae_tpu.models.anchors import grid_anchors
from geomae_tpu.ops import rotated_iou as JR
from geomae_tpu.train import finetune as JFT
from geomae_tpu_torch import apis
from geomae_tpu_torch import test as eval_cli
from geomae_tpu_torch.core import aug_merge, wnms
from geomae_tpu_torch.data.synthetic import write_synthetic_infos
from geomae_tpu_torch.data.waymo import WAYMO_CLASSES
from geomae_tpu_torch.eval import kitti_eval, nuscenes_eval, waymo_eval
from geomae_tpu_torch.models import anchor_head as AH
from geomae_tpu_torch.models.anchor_head import HeadOutputs
from geomae_tpu_torch.train.__main__ import main as train_main
from geomae_tpu_torch.weights import from_flax
from test_torch_port_data import write_waymo_infos
from test_torch_port_weights import randomized_state


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


# the JAX package's rotated IoU, compiled once per shape: called eagerly
# it compiles anew on every call (its ``lax.map`` body is a new function
# each time)
_JAX_IOU = jax.jit(JR.boxes_iou_bev, static_argnames=("row_chunk",))
_JAX_AREA = jax.jit(JR.rect_intersection_area)


@pytest.fixture(autouse=True)
def padded_jax_iou(monkeypatch):
    """The JAX evaluators, weighted NMS and merge call the JAX package's
    ``boxes_iou_bev``; here it runs compiled, on its inputs padded with
    empty boxes to multiples of 64, and returns the real rows and columns
    (each IoU depends on its pair alone), so that a few compiles serve
    every call; its ``rect_intersection_area`` (the volume IoU of weighted
    NMS) runs compiled too."""
    def padded(a, b, row_chunk=128):
        n, m = a.shape[0], b.shape[0]
        pad = lambda x, k: jnp.pad(jnp.asarray(x), ((0, -k % 64), (0, 0)))
        return _JAX_IOU(pad(a, n), pad(b, m), row_chunk=64)[:n, :m]

    monkeypatch.setattr(JR, "boxes_iou_bev", padded)
    monkeypatch.setattr(JR, "rect_intersection_area", _JAX_AREA)


NUS = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
       "motorcycle", "bicycle", "pedestrian", "traffic_cone")


def assert_metrics_equal(got, want):
    """Metric dicts: the same keys, values to 1e-6."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def random_frames(seed, n_frames=4, n=12, n_classes=10, dim=9):
    """Ground truth and predictions: each prediction a GT box moved by up
    to 1.5 m, scaled and turned a little, or a stray box, with a score."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    for _ in range(n_frames):
        m = int(rng.integers(n // 2, n))
        b = np.concatenate([rng.uniform(-30, 30, (m, 2)),
                            rng.uniform(-2, 0, (m, 1)),
                            rng.uniform(0.5, 5, (m, 3)),
                            rng.uniform(-np.pi, np.pi, (m, 1)),
                            rng.normal(0, 2, (m, dim - 7))], -1)
        lab = rng.integers(0, n_classes, m)
        gts.append(dict(boxes=b.astype(np.float32), labels=lab))
        keep = rng.uniform(0, 1, m) < 0.8
        p = b[keep].copy()
        p[:, :2] += rng.normal(0, 0.5, (len(p), 2))
        p[:, 3:6] *= rng.uniform(0.9, 1.1, (len(p), 3))
        p[:, 6] += rng.normal(0, 0.2, len(p))
        stray = b[:3].copy()
        stray[:, :2] = rng.uniform(-30, 30, (3, 2))
        p = np.concatenate([p, stray]).astype(np.float32)
        preds.append(dict(
            boxes=p, scores=rng.uniform(0.05, 1, len(p)).astype(np.float32),
            labels=np.concatenate([lab[keep], rng.integers(0, n_classes, 3)])))
    return preds, gts


def own(gts, seed=0):
    """The ground truth as its own prediction, with scores."""
    rng = np.random.default_rng(seed)
    return [dict(g, scores=rng.uniform(0.1, 1, len(g["labels"]))
                 .astype(np.float32)) for g in gts]


def kitti_frames(preds, gts, seed=1):
    """Names (and, for the ground truth, difficulty fields) from labels in
    [0, 3)."""
    rng = np.random.default_rng(seed)
    names = np.asarray(kitti_eval.CLASSES)
    out_p = [dict(boxes=p["boxes"][:, :7], scores=p["scores"],
                  names=names[p["labels"] % 3]) for p in preds]
    out_g = []
    for g in gts:
        m = len(g["labels"])
        out_g.append(dict(boxes=g["boxes"][:, :7],
                          names=names[g["labels"] % 3],
                          truncated=rng.uniform(0, 0.6, m),
                          occluded=rng.integers(0, 3, m),
                          bbox_height=rng.uniform(20, 60, m)))
    return out_p, out_g


@pytest.mark.parametrize("case", ["random", "ground truth"])
def test_nuscenes_evaluate_and_results_json_match_jax(case):
    """``evaluate`` (mAP, the TP errors, NDS, AP per class) and
    ``format_results_json``, the port's copies against the JAX twins:
    metrics to 1e-6, the JSON equal.  The ground truth scored as its own
    prediction reads mAP 1.0 in both."""
    preds, gts = random_frames(0)
    if case == "ground truth":
        preds = own(gts)
    got = nuscenes_eval.evaluate(preds, gts, NUS)
    want = jnus.evaluate(preds, gts, NUS)
    assert_metrics_equal(got, want)
    assert len(got) > 8 and 0 <= got["NDS"] <= 1
    if case == "ground truth":
        assert abs(got["mAP"] - 1.0) < 1e-12
    tokens = [f"tok{i}" for i in range(len(preds))]
    js = nuscenes_eval.format_results_json(tokens, preds, NUS)
    assert js == jnus.format_results_json(tokens, preds, NUS)
    assert list(js["results"]) == tokens


@pytest.mark.parametrize("case", ["random", "ground truth"])
@pytest.mark.parametrize("metric", ["3d", "bev"])
def test_kitti_evaluators_match_jax(case, metric):
    """``evaluate_kitti`` (AP_R40) and ``evaluate_kitti_ap11`` (the
    reference's 11-point AP over 41 thresholds), their rotated IoU the
    port's against JAX's: metrics to 1e-6, with difficulty gates."""
    preds, gts = random_frames(2, n_frames=3, n=16, n_classes=3, dim=7)
    if case == "ground truth":
        preds = own(gts)
    p, g = kitti_frames(preds, gts)
    got = kitti_eval.evaluate_kitti(p, g, metric=metric)
    assert_metrics_equal(got, jkitti.evaluate_kitti(p, g, metric=metric))
    got11 = kitti_eval.evaluate_kitti_ap11(p, g, metric=metric)
    assert_metrics_equal(got11, jkitti.evaluate_kitti_ap11(p, g,
                                                           metric=metric))
    assert len(got) == 10 and len(got11) == 10
    if case == "ground truth":
        assert got[f"mAP_{metric}_moderate"] == 1.0
    else:
        assert 0 < got[f"mAP_{metric}_moderate"] < 1


@pytest.mark.parametrize("case", ["random", "ground truth"])
def test_waymo_evaluate_matches_jax(case):
    """``evaluate_waymo`` (AP / APH at LEVEL_1 and LEVEL_2, some GTs with
    few points) against the JAX twin: metrics to 1e-6."""
    preds, gts = random_frames(3, n_frames=4, n=14, n_classes=4, dim=7)
    if case == "ground truth":
        preds = own(gts)
    rng = np.random.default_rng(4)
    names = np.asarray(waymo_eval.CLASSES)
    p = [dict(boxes=f["boxes"], scores=f["scores"],
              names=names[f["labels"]]) for f in preds]
    g = [dict(boxes=f["boxes"], names=names[f["labels"]],
              num_points=rng.integers(1, 20, len(f["labels"])))
         for f in gts]
    got = waymo_eval.evaluate_waymo(p, g)
    assert_metrics_equal(got, jwaymo.evaluate_waymo(p, g))
    assert len(got) == 20
    if case == "ground truth":
        assert got["mAP_L2"] == 1.0


def wnms_scene(rng, n=40):
    """Clustered boxes so that suppression and voting both fire."""
    centers = rng.uniform(-30, 30, (n // 5, 2))
    pick = rng.integers(0, len(centers), n)
    yaw = rng.uniform(-np.pi, np.pi, len(centers))[pick]
    boxes = np.concatenate([
        centers[pick] + rng.normal(0, 0.6, (n, 2)), rng.uniform(-2, 0, (n, 1)),
        rng.uniform(1.5, 4.5, (n, 2)), rng.uniform(1.2, 2.2, (n, 1)),
        (yaw + rng.normal(0, 0.1, n))[:, None]], -1).astype(np.float32)
    return boxes, rng.uniform(0.05, 1, n).astype(np.float32)


@pytest.mark.parametrize("use_3d", [False, True])
def test_weighted_nms_matches_jax(use_3d):
    """``weighted_nms`` on clustered corner dets and the per-class driver
    ``box3d_multiclass_wnms`` (two classes, direction bins, a cap),
    through the port's rotated IoU against the JAX twins': kept indices
    and labels exactly, merged boxes and scores to 1e-5."""
    rng = np.random.default_rng(5)
    for _ in range(3):
        boxes, scores = wnms_scene(rng)
        dets = np.concatenate([wnms.boxes7_to_det11(boxes),
                               scores[:, None]], -1)
        assert np.array_equal(dets[:, :11], jwnms.boxes7_to_det11(boxes))
        got_d, got_i = wnms.weighted_nms(dets, 0.1, 0.6, use_3d)
        want_d, want_i = jwnms.weighted_nms(dets, 0.1, 0.6, use_3d)
        assert np.array_equal(got_i, want_i) and len(got_i) < len(boxes)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    cls = np.stack([scores, rng.uniform(0, 1, len(scores)),
                    np.zeros_like(scores)], -1).astype(np.float32)
    dirs = rng.integers(0, 2, len(scores)).astype(np.float32)
    got = wnms.box3d_multiclass_wnms(boxes, cls, 0.3, 10, 0.1, 0.7, use_3d,
                                     dirs)
    want = jwnms.box3d_multiclass_wnms(boxes, cls, 0.3, 10, 0.1, 0.7,
                                       use_3d, dirs)
    assert len(got[1]) == 10
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got[2], want[2])


def test_decode_pre_nms_and_predict_wnms_match_jax():
    """The weighted-NMS prediction of the tiny anchor head on random maps:
    ``decode_pre_nms`` (the top ``nms_pre`` anchors, decoded) against the
    JAX twin, boxes to 1e-5 and the rest exactly, then ``predict_wnms``
    on those outputs: the valid rows, labels, scores and boxes (yaw with
    the direction fix) to 1e-5, padded to ``max_num`` rows."""
    jc = jcfg.tiny_finetune_config()
    hc = jc.head
    rng = np.random.default_rng(6)
    H = W = 20
    A = len(hc.anchor_sizes) * len(hc.rotations)
    maps = [rng.normal(0, s, (2, H, W, A * n)).astype(np.float32) - o
            for n, s, o in ((hc.num_classes, 1.5, 2.0), (hc.code_size, 0.3, 0),
                            (2, 1.0, 0))]
    anchors = grid_anchors(hc, (H, W))
    want = jax.jit(lambda o, a: JAH.decode_pre_nms(o, a, hc))(
        JAH.HeadOutputs(*map(jnp.asarray, maps)), jnp.asarray(anchors))
    out = HeadOutputs(*[torch.from_numpy(m).permute(0, 3, 1, 2).contiguous()
                        for m in maps])
    got = AH.decode_pre_nms(out, torch.from_numpy(anchors), hc)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    dw = JAH.predict_wnms(*want, hc)
    dg = AH.predict_wnms(*got, hc)
    v = np.asarray(dw.valid)
    assert v.any() and np.array_equal(dg.valid.numpy(), v)
    assert dg.boxes.shape == (2, hc.max_num, 9)
    assert np.array_equal(dg.labels.numpy()[v], np.asarray(dw.labels)[v])
    for a, b in ((dg.scores, dw.scores), (dg.boxes, dw.boxes)):
        np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v],
                                   rtol=1e-5, atol=1e-5)


def test_merge_aug_bboxes_matches_jax():
    """``bbox3d_mapping_back`` over flips and scales, and
    ``merge_aug_bboxes_3d`` of four views of clustered boxes (per-class
    NMS through the port's ``nms_bev``): equal to the JAX twins' (the
    boxes to 1e-6); an empty merge stays empty."""
    rng = np.random.default_rng(7)
    boxes, scores = wnms_scene(rng, n=30)
    boxes = np.concatenate([boxes, rng.normal(0, 1, (30, 2))], -1
                           ).astype(np.float32)
    for fh, fv, s in ((True, False, 1.0), (False, True, 1.05),
                      (True, True, 0.95)):
        np.testing.assert_allclose(
            aug_merge.bbox3d_mapping_back(boxes, s, fh, fv),
            jaug.bbox3d_mapping_back(boxes, s, fh, fv), rtol=1e-6)
    results, metas = [], []
    for fh, fv in ((False, False), (True, False), (False, True),
                   (True, True)):
        b = boxes + rng.normal(0, 0.2, boxes.shape).astype(np.float32)
        results.append(dict(boxes=b, scores=rng.uniform(0.1, 1, 30).astype(
            np.float32), labels=rng.integers(0, 3, 30)))
        metas.append(dict(pcd_scale_factor=1.0, pcd_horizontal_flip=fh,
                          pcd_vertical_flip=fv))
    got = aug_merge.merge_aug_bboxes_3d(results, metas, 0.2, 50)
    want = jaug.merge_aug_bboxes_3d(results, metas, 0.2, 50)
    assert 0 < len(got["scores"]) <= 50
    for k in ("scores", "labels"):
        assert np.array_equal(got[k], want[k]), k
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-6)
    empty = dict(boxes=np.zeros((0, 9), np.float32),
                 scores=np.zeros(0, np.float32), labels=np.zeros(0, int))
    assert len(aug_merge.merge_aug_bboxes_3d([empty], [{}], 0.2, 5)[
        "scores"]) == 0


def test_aug_test_matches_jax():
    """``Detector3D.aug_test`` at the tiny anchor width, four flips, from
    the same weights (``from_flax``) on one frame: the merged boxes'
    labels exactly, scores and boxes to 1e-4 (four served views of f32
    models in another order)."""
    jc = jcfg.tiny_finetune_config()
    params, stats = randomized_state(jc, seed=8)
    jdet = japis.Detector3D(jc)
    jdet.state = jdet.state.replace(params=params, batch_stats=stats)
    det = apis.Detector3D(tcfg.tiny_finetune_config(), device="cpu")
    det.model.load_state_dict(from_flax(params, stats), strict=True)
    batch = JFT.dummy_batch(jc, 1, seed=9)
    pts = np.asarray(batch["points"][0])[np.asarray(batch["point_valid"][0])]
    want = jdet.aug_test(pts)
    got = det.aug_test(pts)
    assert 0 < len(got["scores"]) <= jc.head.max_num
    assert np.array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the eval CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """A tiny two-step fine-tune on nuScenes infos on disk, and a
    KITTI-format Waymo tree to score it on."""
    tmp = tmp_path_factory.mktemp("eval")
    nus = str(tmp / "nus")
    write_synthetic_infos(nus, n_frames=6, n_points=4000, n_sweeps=2)
    ft = str(tmp / "ft")
    train_main(["finetune", "--tiny", "--device", "cpu", "--batch-size", "2",
                "--num-workers", "0", "--total-steps", "2", "--data-root",
                nus, "--ann-file", "infos.pkl", "--work-dir", ft])
    way = str(tmp / "waymo")
    ann = write_waymo_infos(way, n_frames=3)
    return tmp, nus, ft, way, ann


def run_cli(monkeypatch, name, argv):
    """``geomae_tpu_torch.test.main(argv)``, recording what it hands to
    the evaluator ``name``: (metrics, the evaluator's arguments)."""
    seen = []
    real = getattr(eval_cli, name)

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(eval_cli, name, spy)
    metrics = eval_cli.main(argv)
    assert len(seen) == 1
    return metrics, seen[0]


@pytest.mark.parametrize("wnms_flag", [False, True])
def test_eval_cli_nuscenes_matches_jax_evaluator(finetuned, monkeypatch,
                                                 wnms_flag):
    """``python -m geomae_tpu_torch.test`` in process on the fine-tune's
    checkpoint over the 6 test-mode frames (batches of 4, the last
    padded), hard or weighted NMS: the metrics equal ``geomae_tpu``'s
    ``evaluate`` on the port's own predictions, every value finite and in
    [0, 1] or an error; ``--out`` holds one entry per token, equal to the
    JAX ``format_results_json`` of those predictions."""
    tmp, nus, ft, _, _ = finetuned
    out = str(tmp / f"results_{wnms_flag}.json")
    argv = ["--work-dir", ft, "--tiny", "--device", "cpu", "--data-root",
            nus, "--ann-file", "infos.pkl", "--out", out]
    metrics, ((preds, gts, classes), _) = run_cli(
        monkeypatch, "evaluate", argv + (["--wnms"] if wnms_flag else []))
    assert_metrics_equal(metrics, jnus.evaluate(preds, gts, classes))
    assert len(preds) == len(gts) == 6
    assert all(np.isfinite(v) and v >= 0 for v in metrics.values())
    assert 0 <= metrics["mAP"] <= 1 and 0 <= metrics["NDS"] <= 1
    assert sum(len(p["scores"]) for p in preds) > 0
    with open(out) as f:
        js = json.load(f)
    tokens = list(js["results"])
    assert len(tokens) == len(set(tokens)) == 6
    want = json.loads(json.dumps(jnus.format_results_json(tokens, preds,
                                                          classes)))
    assert js == want


@pytest.mark.parametrize("dataset,name", [("kitti", "evaluate_kitti"),
                                          ("waymo", "evaluate_waymo")])
def test_eval_cli_kitti_format_matches_jax_evaluator(finetuned, monkeypatch,
                                                     dataset, name):
    """``--dataset kitti`` / ``waymo`` on the KITTI-format Waymo tree of
    ``write_waymo_infos`` (6-channel bins: ``data.load_dim=6``): the
    metrics equal ``geomae_tpu``'s evaluator on the port's own
    predictions (named Car / Pedestrian / Cyclist; a nuScenes class past
    them dropped), all finite in [0, 1]."""
    _, _, ft, way, ann = finetuned
    metrics, (args, kw) = run_cli(monkeypatch, name, [
        "--work-dir", ft, "--tiny", "--device", "cpu", "--data-root", way,
        "--ann-file", ann, "--dataset", dataset, "--batch-size", "2",
        "--cfg-options", "data.load_dim=6"])
    jfn = jkitti.evaluate_kitti if dataset == "kitti" \
        else jwaymo.evaluate_waymo
    assert_metrics_equal(metrics, jfn(*args, **kw))
    preds, gts = args
    assert len(preds) == 3 and sum(len(g["names"]) for g in gts) > 3
    assert all(set(p["names"]) <= set(WAYMO_CLASSES) for p in preds)
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


def test_eval_cli_imports_no_jax():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, geomae_tpu_torch.test, geomae_tpu_torch.core.wnms, "
            "geomae_tpu_torch.core.aug_merge; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'flax', 'geomae_tpu')]; sys.exit(str(bad) if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
