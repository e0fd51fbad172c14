"""Where the time of K8's bf16 backward goes, on one CUDA GPU.

    python -m geomae_tpu_torch.probe_k8_backward [--width C,D]

Builds ``csrc/band_attention.cu`` (with ``segment.cu``, which holds the
error strings) several times into ``build/probe_k8/``: as it is, with its
tensor-core products replaced by a cheap use of their operands, with its
exponentials replaced by their argument, and with ``exp2f`` in place of
``ex2.approx``; then times
``band_attention_fused_backward`` in bf16 (the D prologue and the
tensor-core kernel) on each build at the fine-tune step's [4, 20480] and
the pretrain encoder's [4, 8192] window layouts with CUDA events (20
calls after 3 warm-up, enqueued behind a device spin, every build twice,
in turns).  ``--width`` takes C channels in heads of D, any width of the
kernels (``probe_qkv.width``); the default is the shipped 128 in heads of
16.  A build with a part replaced computes garbage; only its time means
something.

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
SOURCE = "band_attention.cu"


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


def width_arg(what: str) -> tuple:
    """``--width C,D`` parsed for ``what``: (H, D), at a width the kernels
    take."""
    from .probe_qkv import width

    ap = argparse.ArgumentParser(description=what)
    ap.add_argument("--width", type=width, default=(128, 8),
                    help="C,D: C channels in heads of D (default 128,16)")
    C, heads = ap.parse_args().width
    return heads, C // heads


def main() -> None:
    heads = width_arg(__doc__.splitlines()[0])
    if not torch.cuda.is_available():
        raise SystemExit("probe_k8_backward: no CUDA GPU")
    print(probe.card())
    print(f"{heads[0]} heads of {heads[1]}")
    libs = probe.build_variants(SOURCE, VARIANTS, OUT)
    bwd = attention.band_attention_fused_backward
    probe.time_variants(libs, {
        f"{what} {tuple(a[0].shape[:2])}": (lambda a=a: bwd(*a))
        for what, a in ((w, inputs(*lay, heads))
                        for w, lay in layouts().items())})


if __name__ == "__main__":
    main()
