"""Where the time of a fine-tune train step goes, on one CUDA GPU.

    python -m geomae_tpu_torch.profile_train
        [--cfg-options sst.attention_impl=qkv] [--preset nus_centerhead]
        [--trace build/train_trace.json]

Trains ``geomae_finetune_nus()`` (``--preset nus_centerhead``:
``geomae_finetune_nus_centerhead()``) at full width in bf16, batch 4
(``cfg.data.batch_size``), from seeded weights on seeded
``clustered_scene`` batches, and prints

  * the card (nvidia-smi name, power limit, SM clock, power draw);
  * the time of each of 8 steps after two warm-up steps (host clock
    around the synchronised step), their median and quartiles, and the
    peak device memory;
  * the split of one step into forward (voxelize, model, targets and
    losses), backward and optimizer (clip + AdamW), each synchronised;
  * from a ``torch.profiler`` trace of one step: the device's busy time
    (union of kernel, copy and memset intervals), its idle share of the
    step's wall time, device operations per step, the time of the port's
    kernels, and the device operations that take the most time.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .profile_serving import DEVICE_CATS, busy_ms, host_ms, preset_config

SEED = 0
WARMUP = 2
STEPS = 8
# the port's kernels by the names nvcc gives them
KERNEL_NAMES = ("segment_rows_kernel", "segment_scan_kernel",
                "segment_span_kernel",
                "segment_gather_kernel", "band_attention_qkv_kernel",
                "band_attention_qkv_bwd_kernel", "post_attention_kernel",
                "post_attention_fwd_tc_kernel", "post_attention_bwd_kernel",
                "post_attention_bwd_tile_kernel",
                "wgrad_kernel", "sum_partials_kernel",
                "band_attention_kernel", "band_attention_fwd_tc_kernel",
                "band_attention_delta_kernel",
                "band_attention_bwd_tc_kernel",
                "band_attention_bwd_wide_kernel",
                "band_attention_bwd_f32_kernel", "qkv_project_kernel",
                "qkv_project_dx_kernel", "qkv_project_stream_kernel",
                "qkv_project_dx_stream_kernel", "qkv_wgrad_kernel")


def main() -> None:
    from .config import apply_overrides
    from .train.finetune import init_state, make_train_step, synthetic_batch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path,
                    default=Path("build/train_trace.json"),
                    help="where the chrome trace of the profiled step goes")
    ap.add_argument("--preset", default="nus",
                    choices=["nus", "nus_centerhead"],
                    help="the model: the anchor head or the CenterHead")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    metavar="KEY=VAL",
                    help="config overrides, e.g. sst.attention_impl=qkv")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cfg = apply_overrides(preset_config(args.preset), args.cfg_options)
    bz = cfg.data.batch_size
    state = init_state(cfg, "cuda", torch.Generator().manual_seed(SEED))
    step = make_train_step(cfg)
    batches = [synthetic_batch(cfg, bz, seed=SEED + 1 + i, device="cuda")
               for i in range(WARMUP + STEPS + 2)]
    for b in batches[:WARMUP]:
        step(state, b)
    torch.cuda.reset_peak_memory_stats()
    times = [host_ms(lambda: step(state, b))[1]
             for b in batches[WARMUP:WARMUP + STEPS]]
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    print(f"batch {bz}, {cfg.compute_dtype}: step ms {times}")
    print(f"median {med} (quartiles {q1}, {q3}) over {STEPS} steps; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
          "MiB")

    batch = batches[-2]
    for p in state.model.parameters():
        p.grad = None
    losses, t_fwd = host_ms(lambda: step.loss_fn(state.model, batch))
    _, t_bwd = host_ms(lambda: losses["loss"].backward())
    _, t_opt = host_ms(state.tx.step)
    print(f"split ms: forward {t_fwd}, backward {t_bwd}, optimizer {t_opt}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = host_ms(lambda: step(state, batches[-1]))
    args.trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(args.trace))
    events = [e for e in json.loads(args.trace.read_text())["traceEvents"]
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    print(f"profiled step: wall {wall} ms, device busy {busy} ms, idle "
          f"share {1 - busy / wall} under the profiler, {1 - busy / med} "
          f"against the unprofiled median; device ops {len(events)}")
    by_name: dict = {}
    for e in events:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, count + 1)
    print("the port's kernels: ms, calls")
    for k in KERNEL_NAMES:
        hits = [v for n, v in by_name.items() if f"::{k}" in n]
        print(f"  {k}: {sum(v[0] for v in hits):.4f} "
              f"{sum(v[1] for v in hits)}")
    print("device ms, calls, operation:")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:30]:
        print(f"  {ms:9.4f} {count:6d}  {name[:110]}")
    print(f"trace: {args.trace}")


if __name__ == "__main__":
    main()
