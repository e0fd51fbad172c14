"""Where the time of a served frame goes, on one CUDA GPU.

    python -m geomae_tpu_torch.profile_serving
        [--trace build/serving_trace.json] [--preset nus_centerhead]
        [--cfg-options sst.attention_impl=qkv]

Serves synthetic frames (``synthetic.clustered_frame``) through
``inference_detector`` at the full width of ``geomae_finetune_nus()``
(``--preset nus_centerhead``: ``geomae_finetune_nus_centerhead()``) in
bf16, with weights drawn from a seeded generator, and prints

  * the card (nvidia-smi name, power limit, SM clock, power draw);
  * the latency of each of 10 frames after three warm-up frames (host
    clock around the synchronised call) with its median and quartiles;
  * the stage split of one frame (``stage_ms``);
  * from a ``torch.profiler`` trace of two frames: the device's busy time
    (union of kernel, copy and memset intervals), its idle share of the
    frames' wall time, device operations per frame, and the kernels that
    take the most device time.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
WARMUP = 3
FRAMES = 10
PROFILED = 2
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def host_ms(fn):
    """(fn(), milliseconds) on the host clock, synchronised on both ends."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def preset_config(preset: str):
    """The full-width fine-tune config of a CLI preset name."""
    from . import config as C
    return C.geomae_finetune_nus_centerhead() if preset == "nus_centerhead" \
        else C.geomae_finetune_nus()


@torch.no_grad()
def stage_ms(det, raw: np.ndarray) -> dict:
    """Milliseconds of each stage of one served frame: request to tensors,
    voxelize, model, then decode + rotated IoU, greedy NMS over every
    class at once, final selection (the CenterHead: its decode, NMS and
    selection as one stage)."""
    from .apis import to_batch
    from .models.anchor_head import _nms_from_iou, candidates, select
    from .models.center_head import center_head_decode
    from .models.detector import extract_scene

    cfg = det.cfg
    batch, t_batch = host_ms(lambda: to_batch(cfg, raw, det.device))
    scene, t_vox = host_ms(lambda: extract_scene(cfg, *batch))
    out, t_model = host_ms(lambda: det.model(scene))
    stages = {"to_batch": t_batch, "voxelize": t_vox, "model": t_model}
    if cfg.head_type == "center":
        _, t_dec = host_ms(lambda: center_head_decode(
            out, cfg.center_head, cfg.voxel))
        return dict(stages, **{"decode+nms+select": t_dec})
    one = [t[0] for t in out]
    c, t_cand = host_ms(lambda: candidates(*one, det.anchors, cfg.head))
    ok_sorted = torch.gather(c.scores > cfg.head.score_thr, 1, c.order)
    keep, t_nms = host_ms(lambda: _nms_from_iou(c.iou, c.order, ok_sorted,
                                                cfg.head.nms_thr))
    _, t_sel = host_ms(lambda: select(c, keep, cfg.head))
    return {**stages, "decode+iou": t_cand,
            f"nms[{c.order.shape[0]}x{c.order.shape[1]}]": t_nms,
            "select": t_sel}


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> None:
    from .apis import inference_detector, init_model
    from .config import apply_overrides
    from .synthetic import clustered_frame

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path,
                    default=Path("build/serving_trace.json"),
                    help="where the chrome trace of the profiled frames goes")
    ap.add_argument("--preset", default="nus",
                    choices=["nus", "nus_centerhead"],
                    help="the model: the anchor head or the CenterHead")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    metavar="KEY=VAL",
                    help="config overrides, e.g. sst.attention_impl=qkv")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA GPU")

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cfg = apply_overrides(preset_config(args.preset), args.cfg_options)
    det = init_model(cfg=cfg, device="cuda",
                     generator=torch.Generator().manual_seed(SEED))
    n = WARMUP + FRAMES + 1 + PROFILED
    frames = [clustered_frame(np.random.default_rng(SEED + 1 + f), cfg.voxel,
                              cfg.caps.max_points) for f in range(n)]
    for raw in frames[:WARMUP]:
        inference_detector(det, raw)
    lat = [host_ms(lambda: inference_detector(det, raw))[1]
           for raw in frames[WARMUP:WARMUP + FRAMES]]
    q1, med, q3 = np.percentile(lat, [25, 50, 75])
    print(f"latency ms per frame: {lat}")
    print(f"median {med} (quartiles {q1}, {q3}) over {len(lat)} frames")
    print(f"stages ms: {stage_ms(det, frames[WARMUP + FRAMES])}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = host_ms(lambda: [inference_detector(det, raw)
                                   for raw in frames[-PROFILED:]])
    args.trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(args.trace))
    events = [e for e in json.loads(args.trace.read_text())["traceEvents"]
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    print(f"profiled {PROFILED} frames: wall {wall} ms, device busy {busy} "
          f"ms, idle share {1 - busy / wall} under the profiler, "
          f"{1 - busy / PROFILED / med} against the unprofiled median; "
          f"device ops per frame {len(events) / PROFILED}")
    by_name: dict = {}
    for e in events:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, count + 1)
    print("device ms per frame, calls per frame, kernel:")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms / PROFILED:9.4f} {count / PROFILED:8.1f}  {name[:100]}")
    print(f"trace: {args.trace}")


if __name__ == "__main__":
    main()
