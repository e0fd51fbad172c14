"""Smoke run of the PyTorch port's detection serving path on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``geomae_tpu_torch/csrc`` with ``nvcc``, then

  A. holds each kernel against its plain PyTorch version on the card, at
     the serving path's shapes, in float32 and bfloat16, and times both
     with CUDA events;
  B. serves 3 synthetic frames through ``inference_detector`` at the full
     width of ``geomae_finetune_nus()`` in bfloat16, checks the detections
     and that each kernel launched the expected number of times per frame;
  C. runs one frame in float32 through the port on the GPU (kernels) and
     on the CPU (plain versions) from the same seeded weights and compares
     the voxel table, the SST output, the FPN map and the head logits.

Any failed check exits non-zero.  The line before the last is a JSON
summary of the kernels: ``ms`` and ``plain_ms`` are the times of one call
of each distinct call a served frame makes of the kernel, summed (for
``segment_broadcast``, its f32 mean plus its bf16 max); the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FRAMES = 3
DEVICE = "cuda"
# kernel launches per served frame: 6 SST blocks of 2 layers; the VFE's
# cluster mean and max gather-back, and its final pillar max
PER_FRAME = {"segment_reduce": 1, "segment_broadcast": 2,
             "band_attention_qkv": 12, "post_attention_block": 12}
# (atol, rtol) per kernel and dtype.  f32: the kernel and the plain
# version sum in other orders (cuBLAS, atomics).  bf16: the same order
# differences may move a compute-dtype rounding to the other side, at the
# output or at an intermediate point (bias adds, LayerNorm output, GELU;
# K6's probabilities, rounded against a running max); one bf16 ulp is at
# most 2^-7 relative, and 2^-6 = 1.6e-2 absolute for outputs below 4.
# Max is selection: exact.
TOL = {
    ("segment_reduce", "max"): {torch.float32: (0.0, 0.0),
                                torch.bfloat16: (0.0, 0.0)},
    ("segment_broadcast", "max"): {torch.float32: (0.0, 0.0),
                                   torch.bfloat16: (0.0, 0.0)},
    ("segment_broadcast", "mean"): {torch.float32: (1e-4, 1e-6),
                                    torch.bfloat16: (1e-6, 2 ** -7)},
    ("band_attention_qkv", ""): {torch.float32: (1e-4, 1e-4),
                                 torch.bfloat16: (2e-2, 2e-2)},
    ("post_attention_block", ""): {torch.float32: (1e-4, 1e-4),
                                   torch.bfloat16: (2e-2, 2e-2)},
}
# the dtype each call of the serving path runs in
PATH_DTYPE = {("segment_reduce", "max"): torch.bfloat16,
              ("segment_broadcast", "mean"): torch.float32,
              ("segment_broadcast", "max"): torch.bfloat16,
              ("band_attention_qkv", ""): torch.bfloat16,
              ("post_attention_block", ""): torch.bfloat16}
KERNELS = {
    "segment_reduce": ("geomae_tpu_torch/csrc/segment.cu",
                       "geomae_tpu/ops/pallas_segreduce.py:220"),
    "segment_broadcast": ("geomae_tpu_torch/csrc/segment.cu",
                          "geomae_tpu/ops/pallas_segreduce.py:553"),
    "band_attention_qkv": ("geomae_tpu_torch/csrc/window_attention.cu",
                           "geomae_tpu/ops/pallas_attention_qkv.py:928"),
    "post_attention_block": ("geomae_tpu_torch/csrc/post_attention.cu",
                             "geomae_tpu/ops/pallas_ffn.py:338"),
}
PARITY_TOL = (1e-3, 1e-3)      # f32 GPU against CPU, whole model


class Failed(Exception):
    pass


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def compare(label: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, failures: list) -> float:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = atol + rtol * w.abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.isfinite(g).all()) and g.shape == w.shape and not bool(
        (err > bound).any())
    # the largest error as a share of its own bound: 1 is the limit
    share = f", worst share of bound {float((err / bound).max()):.3f}" \
        if atol or rtol else ""
    print(f"  {label}: max_abs_err {max_abs:.3e} (atol {atol:g}, rtol "
          f"{rtol:g}{share}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(label)
    return max_abs


def startup():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs the port on a CUDA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("device (nvidia-smi name, power.limit):")
    print(smi[0])
    from geomae_tpu_torch.ops import _cuda
    nvcc = subprocess.run([_cuda.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1]}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions (f32 compares are "
          "full f32)")
    path = _cuda.library_path()
    built = not path.exists()
    t = time.perf_counter()
    _cuda.library()
    print(f"kernels: {path.name} "
          f"{'built' if built else 'found'} in "
          f"{time.perf_counter() - t:.1f} s")
    log = path.with_name(path.name + ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Function properties for" in line or "Used" in line \
                    or "spill" in line:
                print(f"  ptxas: {line.split(':', 1)[-1].strip()}")


def serving_inputs(cfg, device):
    """A realistic frame's scene and window layouts on ``device``."""
    from geomae_tpu_torch.apis import to_batch
    from geomae_tpu_torch.models.detector import extract_scene
    from geomae_tpu_torch.models.sst import prepare_shift_data
    from geomae_tpu_torch.ops.windows import make_layouts
    from geomae_tpu_torch.synthetic import clustered_frame

    raw = clustered_frame(np.random.default_rng(SEED), cfg.voxel,
                          cfg.caps.max_points)
    scene = extract_scene(cfg, *to_batch(cfg, raw, device))
    t = scene.table
    layouts = make_layouts(t.coords, t.valid, cfg.sst, cfg.voxel)
    shift = prepare_shift_data(layouts, t.valid, cfg.sst)
    occ = []
    for lay in shift["layers"]:
        w = lay["win_id"][0]
        w = w[w != 2 ** 31 - 1]
        occ.append(int(torch.unique_consecutive(
            w, return_counts=True)[1].max()))
    print(f"frame: {len(raw)} points, {int(t.num_voxels[0])} pillars "
          f"(cap {t.valid.shape[1]}), "
          f"{int((t.point2voxel[0] < t.valid.shape[1]).sum())} points in "
          f"cap, largest window per shift {occ}")
    return scene, shift


def phase_a(cfg, results: dict, failures: list) -> None:
    from geomae_tpu_torch.ops import attention_qkv, ffn, segment

    print("phase A: kernels against their plain versions, serving shapes")
    dev = torch.device(DEVICE)
    scene, shift = serving_inputs(cfg, dev)
    t = scene.table
    V = t.valid.shape[1]
    P = scene.points.shape[1]
    p2v = t.point2voxel
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    C, Fd = cfg.sst.d_model, cfg.sst.dim_feedforward
    xyz = torch.where(scene.valid[..., None], scene.points[..., :3], 0.0)
    feats = {
        ("segment_reduce", "max"): randn(1, P, cfg.vfe.feat_channels[-1]),
        ("segment_broadcast", "max"): randn(1, P, cfg.vfe.feat_channels[0]),
        ("segment_broadcast", "mean"): xyz.contiguous(),
    }
    attn_w = [randn(C, C, scale=C ** -0.5) if i % 2 == 0
              else randn(C, scale=0.1) for i in range(6)]
    lay = shift["layers"][1]
    x_tok, a_tok = randn(1, V, C), randn(1, V, C)
    ffn_w = [randn(C, C, scale=0.1), randn(C, scale=0.1),
             1 + randn(C, scale=0.1), randn(C, scale=0.1),
             randn(C, Fd, scale=0.1), randn(Fd, scale=0.1),
             randn(Fd, C, scale=0.1), randn(C, scale=0.1),
             1 + randn(C, scale=0.1), randn(C, scale=0.1)]

    for key, tols in TOL.items():
        name, op = key
        for dt, (atol, rtol) in tols.items():
            if name == "segment_reduce":
                x = feats[key].to(dt)
                args = (x, p2v, V, op)
                kern, plain = segment.segment_reduce, \
                    segment.segment_reduce_plain
            elif name == "segment_broadcast":
                x = feats[key].to(dt)
                args = (x, p2v, V, op)
                kern, plain = segment.segment_broadcast, \
                    segment.segment_broadcast_plain
            elif name == "band_attention_qkv":
                args = (x_tok.to(dt), lay["pos_sorted"], *attn_w,
                        lay["win_id"], lay["key_valid_sorted"],
                        cfg.sst.nhead)
                kern = attention_qkv.band_attention_qkv
                plain = attention_qkv.band_attention_qkv_plain
            else:
                args = (x_tok.to(dt), a_tok.to(dt), *ffn_w, lay["extent"])
                kern = ffn.post_attention_block
                plain = ffn.post_attention_block_plain
            label = f"{name}{'(' + op + ')' if op else ''} {str(dt)[6:]} " \
                    f"{tuple(args[0].shape)}"
            got = kern(*args)
            torch.cuda.synchronize()
            err = compare(label, got, plain(*args), atol, rtol, failures)
            ms = cuda_ms(lambda: kern(*args))
            plain_ms = cuda_ms(lambda: plain(*args), iters=5, warmup=1)
            print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if PATH_DTYPE[key] == dt:
                results.setdefault(name, []).append((err, ms, plain_ms))


def reset_counts():
    from geomae_tpu_torch.ops import attention_qkv, ffn, segment
    fns = {"segment_reduce": segment.segment_reduce,
           "segment_broadcast": segment.segment_broadcast,
           "band_attention_qkv": attention_qkv.band_attention_qkv,
           "post_attention_block": ffn.post_attention_block}
    for fn in fns.values():
        fn.launches = 0
    return fns


def phase_b(cfg, failures: list) -> dict:
    from geomae_tpu_torch.apis import inference_detector, init_model
    from geomae_tpu_torch.profile_serving import host_ms, stage_ms
    from geomae_tpu_torch.synthetic import clustered_frame

    print(f"phase B: {FRAMES} frames through inference_detector, "
          f"{cfg.compute_dtype}, full width")
    det = init_model(cfg=cfg, device=DEVICE,
                     generator=torch.Generator().manual_seed(SEED))
    frames = [clustered_frame(np.random.default_rng(SEED + 1 + f),
                              cfg.voxel, cfg.caps.max_points)
              for f in range(FRAMES)]
    torch.cuda.reset_peak_memory_stats()
    fns = reset_counts()
    outs = []
    for f, raw in enumerate(frames):
        res, ms = host_ms(lambda: inference_detector(det, raw))
        outs.append(res)
        print(f"  frame {f}: {len(raw)} points -> {len(res['scores'])} "
              f"detections in {ms:.1f} ms")
    launches = {k: fn.launches for k, fn in fns.items()}
    print(f"  launches in {FRAMES} frames: {launches}")
    for k, per in PER_FRAME.items():
        if launches[k] != per * FRAMES:
            failures.append(f"{k} launched {launches[k]} times, expected "
                            f"{per * FRAMES}")
    for res in outs:
        n = len(res["scores"])
        ok = (res["boxes"].shape == (n, 9)
              and np.isfinite(res["boxes"]).all()
              and ((res["scores"] > 0) & (res["scores"] <= 1)).all()
              and ((res["labels"] >= 0)
                   & (res["labels"] < cfg.head.num_classes)).all())
        if not ok or n == 0:
            failures.append(f"frame detections malformed ({n} boxes)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    stages = stage_ms(det, frames[-1])
    print("  stages of one more frame (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()))
    return launches


def phase_c(cfg, failures: list) -> None:
    from geomae_tpu_torch.apis import Detector3D, replace, to_batch
    from geomae_tpu_torch.models.detector import extract_scene
    from geomae_tpu_torch.synthetic import clustered_frame

    cfg32 = replace(cfg, compute_dtype="float32")
    print("phase C: one frame in float32, GPU kernels against CPU plain "
          "versions, same seeded weights")
    raw = clustered_frame(np.random.default_rng(SEED + 1), cfg.voxel,
                          cfg.caps.max_points)
    got = {}
    for dev in (DEVICE, "cpu"):
        det = Detector3D(cfg32, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
        seen = []
        hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o))
                 for m in (det.model.backbone.encoder_blocks, det.model.neck)]
        t = time.perf_counter()
        with torch.no_grad():
            scene = extract_scene(cfg32, *to_batch(cfg32, raw, dev))
            out = det.model(scene)
        if dev != "cpu":
            torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        print(f"  {dev}: {(time.perf_counter() - t):.1f} s")
        got[dev] = (scene, *seen, out)
    (sg, xg, fg, og), (sc, xc, fc, oc) = got[DEVICE], got["cpu"]
    differ = [f for f in ("coords", "valid", "num_voxels", "point2voxel")
              if not torch.equal(getattr(sg.table, f).cpu(),
                                 getattr(sc.table, f))]
    print(f"  voxel table: {differ or 'bitwise equal'}")
    failures += [f"voxel table {f} differs" for f in differ]
    valid = sc.table.valid
    compare("SST output (valid rows)", xg.cpu()[valid], xc[valid],
            *PARITY_TOL, failures)
    compare(f"FPN output {tuple(fc.shape)}, max |x| "
            f"{float(fc.abs().max()):.3e}", fg.cpu(), fc, *PARITY_TOL,
            failures)
    for name, a, b in zip(og._fields, og, oc):
        compare(f"head {name} {tuple(b.shape)}, std {float(b.std()):.3e}",
                a.cpu(), b, *PARITY_TOL, failures)


def main() -> None:
    from geomae_tpu_torch.apis import geomae_finetune_nus

    startup()
    cfg = geomae_finetune_nus()
    failures: list = []
    results: dict = {}
    phase_a(cfg, results, failures)
    if failures:
        raise Failed(f"phase A: {failures}")
    launches = phase_b(cfg, failures)
    if failures:
        raise Failed(f"phase B: {failures}")
    phase_c(cfg, failures)
    if failures:
        raise Failed(f"phase C: {failures}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rows = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r[0] for r in rows),
            ms=sum(r[1] for r in rows),
            plain_ms=sum(r[2] for r in rows)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
