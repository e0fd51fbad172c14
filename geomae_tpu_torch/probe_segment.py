"""K1 (``segment_reduce``) and K2 (``segment_broadcast``) on one CUDA GPU:
their time at the path's shapes, on a skewed frame, and the first
kernel's share of it.

    python -m geomae_tpu_torch.probe_segment

Builds ``csrc/segment.cu`` once per entry of ``VARIANTS`` (as built,
and without its second kernel: the first kernel's share) into
``build/probe_segment/``, then times the seven calls the VFE makes (K1
max bf16 [B, 262144, 128] -> [B, 20480, 128], K2 max bf16 [B, 262144,
64], K2 mean f32 [B, 262144, 3] at serving batch 1 (s) and training
batch 4 (t), and K2 sum f32 [4, 262144, 64], K2 max's backward) on
each build with ``probe.cuda_ms`` (20 calls after 3 warm-up, enqueued
behind a device spin, every build twice, in turns).  The scenes are
``chip_smoke.py``'s: a ``clustered_frame`` and a fine-tune batch of
``clustered_scene`` samples, voxelized; and a skewed copy of the frame
in which one pillar holds a tenth of its points in the cap, so that a
design held back by one long pillar shows.  Prints each scene's
points-per-pillar histogram and largest pillar first.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import numpy as np
import torch

from . import probe
from .ops import _cuda, segment

OUT = _cuda.BUILD_DIR.parent / "probe_segment"
SPAN = "  return cudaLaunchKernelEx(&cfg, segment_span_kernel"
VARIANTS = {
    "as built": [],
    # the first kernel alone (computes garbage where a block's edge cuts a
    # segment)
    "no second kernel": [(SPAN, "  if (true) return cudaSuccess;\n" + SPAN)],
}


def pillar_histogram(p2v: torch.Tensor, V: int):
    """(histogram of points per pillar, largest pillar) over the pillars
    in the cap of a [B, P] point-to-pillar map: K1's and K2's segments."""
    ok = p2v < V
    rows = (p2v.long() + V * torch.arange(p2v.shape[0],
                                          device=p2v.device)[:, None])[ok]
    sizes = torch.bincount(rows, minlength=p2v.shape[0] * V)
    sizes = sizes[sizes > 0].cpu()
    edges = [1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513, 2 ** 31 - 1]
    hist = {f"{a}-{b - 1}" if b < edges[-1] else f"{a}+":
            int(((sizes >= a) & (sizes < b)).sum())
            for a, b in zip(edges, edges[1:])}
    return hist, int(sizes.max()) if sizes.numel() else 0


def skewed(p2v: torch.Tensor, V: int, share: float = 0.1) -> torch.Tensor:
    """``p2v`` [1, P] with the middle ``share`` of its points in the cap
    merged into one pillar, the ids ranked densely again."""
    seg = p2v[0].clone()
    n = int((seg < V).sum())
    a = n // 2
    seg[a:a + int(n * share)] = seg[a]
    ids = seg[:n]
    new = torch.ones_like(ids)
    new[1:] = (ids[1:] != ids[:-1]).int()
    seg[:n] = (new.cumsum(0) - 1).int()
    return seg[None].contiguous()


def scenes() -> dict:
    """{label: (p2v [B, P] int32, V)} on the card: the served frame, the
    fine-tune batch and the skewed frame."""
    from .apis import geomae_finetune_nus, to_batch
    from .models.detector import extract_scene
    from .synthetic import clustered_frame
    from .train.finetune import synthetic_batch

    cfg = geomae_finetune_nus()
    dev = torch.device("cuda")
    raw = clustered_frame(np.random.default_rng(0), cfg.voxel,
                          cfg.caps.max_points)
    one = extract_scene(cfg, *to_batch(cfg, raw, dev)).table
    b = synthetic_batch(cfg, cfg.data.batch_size, seed=0, device=dev)
    four = extract_scene(cfg, b["points"], b["point_valid"]).table
    V = one.valid.shape[1]
    return {"s": (one.point2voxel, V), "t": (four.point2voxel, V),
            "skewed s": (skewed(one.point2voxel, V), V)}


def calls(label: str, p2v: torch.Tensor, V: int) -> dict:
    """{row label: call} of the VFE's K1 and K2 calls on ``p2v``, seeded
    payloads in the path's dtypes (K2 sum, a training row, at t only)."""
    B, P = p2v.shape
    g = torch.Generator(device="cuda").manual_seed(B)
    r = lambda c, dt: torch.randn(B, P, c, generator=g, device="cuda").to(dt)
    x1, x2, x3 = r(128, torch.bfloat16), r(64, torch.bfloat16), \
        r(3, torch.float32)
    out = {f"K1 max bf16 {label}":
           lambda: segment.segment_reduce(x1, p2v, V, "max"),
           f"K2 max bf16 {label}":
           lambda: segment.segment_broadcast(x2, p2v, V, "max"),
           f"K2 mean f32 {label}":
           lambda: segment.segment_broadcast(x3, p2v, V, "mean")}
    if label == "t":
        x4 = r(64, torch.float32)
        out[f"K2 sum f32 {label}"] = lambda: segment.segment_broadcast(
            x4, p2v, V, "sum")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_segment: no CUDA GPU")
    print(probe.card())
    libs = probe.build_variants("segment.cu", VARIANTS, OUT)
    todo = {}
    for label, (p2v, V) in scenes().items():
        hist, top = pillar_histogram(p2v, V)
        print(f"{label}: {tuple(p2v.shape)}, {int((p2v < V).sum())} points "
              f"in {V} pillars; points per pillar {hist}; largest {top}")
        todo.update(calls(label, p2v, V))
    probe.time_variants(libs, todo)


if __name__ == "__main__":
    main()
