"""Where the time of a GeoMAE pretrain train step goes, on one CUDA GPU.

    python -m geomae_tpu_torch.profile_pretrain
        [--trace build/pretrain_trace.json]
        [--cfg-options sst.attention_impl=qkv]
    # the data-parallel step under a one-rank NCCL group
    torchrun --standalone --nproc_per_node 1 \\
        -m geomae_tpu_torch.profile_pretrain

Trains ``geomae_pretrain_nus()`` at full width in bf16, batch 4
(``cfg.data.batch_size``, the batch ``bench.py`` times on the TPU), from
seeded weights on seeded ``synthetic_batch`` clouds with a seeded mask
generator on the card, and prints

  * the card (nvidia-smi name, power limit, SM clock, power draw);
  * the time of each of 8 steps after two warm-up steps (host clock
    around the synchronised step), their median and quartiles, and the
    peak device memory;
  * the split of one step into targets (voxelize, K3, the moment rows,
    K4, stencil, eig3 and the mask), forward (GeoMAE and the loss),
    backward, the gradient all-reduce and optimizer (clip + AdamW), each
    synchronised;
  * from a ``torch.profiler`` trace of one step: the device's busy time
    (union of kernel, copy and memset intervals), its idle share of the
    step's wall time, device operations per step, the time of the port's
    kernels and of the collectives (NCCL's kernels), and the device
    operations that take the most time.

Under ``torchrun`` (``WORLD_SIZE`` set) the step runs in the process
group ``parallel.mesh.init_distributed`` joins, on the rank's replica.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .profile_serving import DEVICE_CATS, busy_ms, host_ms
from .profile_train import KERNEL_NAMES

SEED = 0
WARMUP = 2
STEPS = 8
PRETRAIN_KERNELS = KERNEL_NAMES + ("slot_outer_kernel", "expand_rows_kernel")


def main() -> None:
    from .config import apply_overrides, geomae_pretrain_nus
    from .models.mae import pretrain_loss
    from .parallel.distributed import all_reduce_grads, data_parallel
    from .parallel.mesh import init_distributed
    from .train.pretrain import (init_state, make_train_step,
                                 synthetic_batch, targets_and_mask)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path,
                    default=Path("build/pretrain_trace.json"),
                    help="where the chrome trace of the profiled step goes")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    metavar="KEY=VAL",
                    help="config overrides, e.g. sst.attention_impl=qkv")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_pretrain: no CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    group = init_distributed("cuda") if "WORLD_SIZE" in os.environ else None
    device = "cuda" if group is None else group.device
    if group is not None:
        print(f"process group: rank {group.rank} of {group.world} on {device}")
    cfg = apply_overrides(geomae_pretrain_nus(), args.cfg_options)
    bz = cfg.data.batch_size
    state = init_state(cfg, device, torch.Generator().manual_seed(SEED))
    step = make_train_step(cfg, group)
    gen = torch.Generator(device=device).manual_seed(SEED)
    batches = [synthetic_batch(cfg, bz, seed=SEED + 1 + i, device=device)
               for i in range(WARMUP + STEPS + 2)]
    for b in batches[:WARMUP]:
        step(state, b, gen)
    torch.cuda.reset_peak_memory_stats()
    times = [host_ms(lambda: step(state, b, gen))[1]
             for b in batches[WARMUP:WARMUP + STEPS]]
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    print(f"batch {bz}, {cfg.compute_dtype}: step ms {times}")
    print(f"median {med} (quartiles {q1}, {q3}) over {STEPS} steps; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
          "MiB")
    if group is not None:
        # the same steps made with and without the group, in turns
        alone, turns = make_train_step(cfg), {True: [], False: []}
        for i, b in enumerate(batches[WARMUP:WARMUP + STEPS]):
            for grouped in ((True, False) if i % 2 else (False, True)):
                fn = step if grouped else alone
                turns[grouped].append(host_ms(lambda: fn(state, b, gen))[1])
        print(f"in turns, step ms with the group {turns[True]}, without "
              f"{turns[False]}; medians {np.median(turns[True])}, "
              f"{np.median(turns[False])}")

    batch, model = batches[-2], state.model
    for p in model.parameters():
        p.grad = None
    with data_parallel(group):
        (scene, tg, keep), t_tgt = host_ms(
            lambda: targets_and_mask(cfg, batch, gen))
        losses, t_fwd = host_ms(lambda: pretrain_loss(
            model(scene, keep), tg, scene, keep, cfg))

    _, t_bwd = host_ms(lambda: losses["loss"].backward())
    _, t_ar = host_ms(lambda: all_reduce_grads(model, group))
    _, t_opt = host_ms(state.tx.step)
    print(f"split ms: targets and mask {t_tgt}, forward {t_fwd}, backward "
          f"{t_bwd}, gradient all-reduce {t_ar}, optimizer {t_opt}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = host_ms(lambda: step(state, batches[-1], gen))
    args.trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(args.trace))
    trace = [e for e in json.loads(args.trace.read_text())["traceEvents"]
             if "dur" in e]
    events = [e for e in trace if e.get("cat") in DEVICE_CATS]
    comms = [e for e in trace
             if str(e.get("name", "")).startswith(("nccl:", "gloo:"))]
    busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    print(f"profiled step: wall {wall} ms, device busy {busy} ms, idle "
          f"share {1 - busy / wall} under the profiler, {1 - busy / med} "
          f"against the unprofiled median; device ops {len(events)}")
    by_name: dict = {}
    for e in events:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, count + 1)
    print("the port's kernels: ms, calls")
    for k in PRETRAIN_KERNELS:
        hits = [v for n, v in by_name.items() if f"::{k}" in n]
        print(f"  {k}: {sum(v[0] for v in hits):.4f} "
              f"{sum(v[1] for v in hits)}")
    hits = [v for n, v in by_name.items() if "nccl" in n.lower()]
    coll = sum(v[0] for v in hits)
    host = sum(e["dur"] for e in comms) / 1e3
    print(f"collectives: {len(comms)} calls "
          f"({sorted({e['name'] for e in comms})}), {host:.4f} ms of host "
          f"time, {host / wall} of the profiled step; NCCL kernels "
          f"{coll:.4f} ms in {sum(v[1] for v in hits)} launches, "
          f"{coll / busy} of device busy")
    print("device ms, calls, operation:")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:30]:
        print(f"  {ms:9.4f} {count:6d}  {name[:110]}")
    print(f"trace: {args.trace}")
    if group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
