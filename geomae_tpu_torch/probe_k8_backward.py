"""Where the time of K8's bf16 backward goes, on one CUDA GPU.

    python -m geomae_tpu_torch.probe_k8_backward [--width C,D]
    python -m geomae_tpu_torch.probe_k8_backward --tiles

Builds ``csrc/band_attention.cuh`` and its units (with ``segment.cu``,
which holds the error strings) several times into ``build/probe_k8/``: as
it is, with its tensor-core products replaced by a cheap use of their
operands, with its exponentials replaced by their argument, and with
``exp2f`` in place of ``ex2.approx``; then times
``band_attention_fused_backward`` in bf16 (the D prologue and the
tensor-core kernel) on each build at the fine-tune step's [4, 20480] and
the pretrain encoder's [4, 8192] window layouts with CUDA events (20
calls after 3 warm-up, enqueued behind a device spin, every build twice,
in turns).  ``--width`` takes C channels in heads of D, any width of the
kernels (``probe_qkv.width``); the default is the shipped 128 in heads of
16.  A build with a part replaced computes garbage; only its time means
something.

``--tiles`` builds the header as it is and with the tiling above D = 128
that the kernel had first (``TILE_VARIANTS``: 32-token tiles and 32-row
chunks, two warps a block, where the kernel takes 64-token tiles and
16-row chunks in four warps) and times the backward on both, in turns,
at C 256 in one head of 256, C 512 in two, C 384 in two of 192, and C
256 in two of 128, whose kernel the edits leave as it is.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import argparse

import torch

from . import probe
from .ops import _cuda, attention

OUT = _cuda.BUILD_DIR.parent / "probe_k8"
# each product's operands still read, so the compiler keeps their loads
FAKE_MMA = '''#include "mma.cuh"
namespace geomae {
__device__ __forceinline__ void fake_mma(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t* b) {
  d[0] += __uint_as_float(a[0] ^ b[0]);
  d[1] += __uint_as_float(a[3] ^ b[1]);
}
}  // namespace geomae'''
VARIANTS = {
    "as built": [],
    "no products": [('#include "mma.cuh"', FAKE_MMA),
                    ("        mma_bf16_16816(", "        fake_mma(")],
    "no exp": [("? ex2(fmaf(", "? (fmaf(")],
    "exp2f": [("? ex2(fmaf(", "? exp2f(fmaf(")],
}
# The backward above D = 128 with 32-token tiles as well as 32-row chunks,
# 2 x 32 threads a block (at D <= 128 kRows is 64, and every edit gives
# back the same constants)
TILE_VARIANTS = {
    "as built": [],
    "32-token tiles": [
        ("kRows = D > 128 ? 16 : kChunk;", "kRows = D > 128 ? 32 : kChunk;"),
        ("tile[4][kTile * kRS];", "tile[4][kRows * kRS];"),
        ("e += kTcThreads) {", "e += 2 * K::kRows) {"),
        ("__launch_bounds__(kTcThreads, BwdTc<D>::kMinBlocks)",
         "__launch_bounds__(2 * BwdTc<D>::kRows, BwdTc<D>::kMinBlocks)"),
        ("constexpr int kChunk = K::kRows;",
         "constexpr int kChunk = K::kRows, kTile = K::kRows;"),
        ("grid((args.V + kTile - 1) / kTile,",
         "grid((args.V + K::kRows - 1) / K::kRows,"),
        ("<<<grid, kTcThreads, kBytes, stream>>>",
         "<<<grid, 2 * K::kRows, kBytes, stream>>>")]}
# (heads, head width) of --tiles
TILE_WIDTHS = ((1, 256), (2, 256), (2, 192), (2, 128))


def layouts() -> dict:
    """(win_id, key_valid) of the fine-tune step's layer-1 windows at batch
    4 and of the pretrain encoder's visible tokens at batch 4."""
    from .apis import geomae_finetune_nus
    from .config import geomae_pretrain_nus
    from .models.detector import extract_scene
    from .models.mae import encoder_shift_data, sample_mask, visible_rows
    from .models.sst import prepare_shift_data
    from .ops.voxelize import build_scene_batch
    from .ops.windows import make_layouts
    from .train import finetune, pretrain

    dev = torch.device("cuda")
    cfg = geomae_finetune_nus()
    b = finetune.synthetic_batch(cfg, 4, seed=0, device=dev)
    t = extract_scene(cfg, b["points"], b["point_valid"]).table
    lay = prepare_shift_data(make_layouts(t.coords, t.valid, cfg.sst,
                                          cfg.voxel), t.valid,
                             cfg.sst)["layers"][1]
    out = {"fine-tune": (lay["win_id"], lay["key_valid_sorted"])}
    cfg = geomae_pretrain_nus()
    b = pretrain.synthetic_batch(cfg, 4, seed=0, device=dev)
    t = build_scene_batch(b["points"], b["point_valid"], cfg.voxel,
                          cfg.caps.max_voxels).table
    keep = sample_mask(torch.Generator(device=dev).manual_seed(0), t.valid,
                       cfg.mae.random_mask_ratio)
    vis_raw, _, vis_valid = visible_rows(keep, cfg.caps.max_visible)
    lay = encoder_shift_data(t, vis_raw, vis_valid, cfg)["layers"][1]
    out["encoder"] = (lay["win_id"], lay["key_valid_sorted"])
    return out


def inputs(win, kv, heads: tuple = (8, 16)):
    """The backward's arguments on one layout: seeded bf16 q, k, v and
    cotangent in ``heads`` = (H, D) (the shipped 8 heads of 16 unless
    said), the forward's output and statistics."""
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (*win.shape, *heads)
    q, k, v, d = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                  for _ in range(4))
    out, lse = attention._forward(q, k, v, win, kv, stats=True)
    return q, k, v, win, kv, out, lse, d


def width_parser(what: str) -> argparse.ArgumentParser:
    """A parser for ``what`` that takes ``--width C,D`` (a width the kernels
    take) as (C, heads)."""
    from .probe_qkv import width

    ap = argparse.ArgumentParser(description=what)
    ap.add_argument("--width", type=width, default=(128, 8),
                    help="C,D: C channels in heads of D (default 128,16)")
    return ap


def width_arg(what: str) -> tuple:
    """``--width C,D`` parsed for ``what``: (H, D), at a width the kernels
    take."""
    C, heads = width_parser(what).parse_args().width
    return heads, C // heads


def main() -> None:
    ap = width_parser(__doc__.splitlines()[0])
    ap.add_argument("--tiles", action="store_true",
                    help="the tiling above D 128, at TILE_WIDTHS")
    args = ap.parse_args()
    heads, tiles = (args.width[1], args.width[0] // args.width[1]), args.tiles
    if not torch.cuda.is_available():
        raise SystemExit("probe_k8_backward: no CUDA GPU")
    print(probe.card())
    widths = TILE_WIDTHS if tiles else (heads,)
    print(", ".join(f"{h} heads of {d}" for h, d in widths))
    libs = probe.build_variants(probe.K8_HEADER,
                                TILE_VARIANTS if tiles else VARIANTS, OUT,
                                probe.K8_UNITS)
    bwd = attention.band_attention_fused_backward
    probe.time_variants(libs, {
        f"{what} {tuple(a[0].shape[:2])} {h} x {d}": (lambda a=a: bwd(*a))
        for h, d in widths
        for what, a in ((w, inputs(*lay, (h, d)))
                        for w, lay in layouts().items())})


if __name__ == "__main__":
    main()
