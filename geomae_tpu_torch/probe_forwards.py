"""Where the time of K5's and K8's bf16 forwards goes, on one CUDA GPU.

    python -m geomae_tpu_torch.probe_forwards [--width C,D]

Builds K5's sources (``csrc/post_attention.cuh`` and the translation
units that include it) and ``csrc/band_attention.cu`` (each with
``segment.cu``, which holds the error strings) several times into
``build/probe_forwards/``: as they are and with one design choice
changed or one part removed, then times ``post_attention_block`` and
``band_attention_fused`` (under its statistics, as a train step calls
it) in bf16 on each build with CUDA events (``probe.cuda_ms``: 20 calls
after 3 warm-up, enqueued behind a device spin, every build twice, in
turns).  K5 at the fine-tune step's [4, 20480], the pretrain encoder's
[4, 8192] and the served frame's [1, 20480] tokens; K8 on the fine-tune
step's layer-1 windows and the pretrain encoder's, in the heads
``--width`` names (C channels in heads of D, any width of the kernels;
the default is the shipped 128 in heads of 16), with each K8 build's
registers and spills at that width; at D 8 also 8 heads a block (at
three and two blocks an SM) and 4 heads at three.  A build with a part
removed computes garbage; only its time means something.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import torch

from . import probe
from .ops import _cuda, attention, ffn
from .probe_k8_backward import FAKE_MMA, inputs, layouts, width_arg

OUT = _cuda.BUILD_DIR.parent / "probe_forwards"
# K5: one block an SM with a three-buffer weight ring (128 KB of shared
# memory) in place of two blocks an SM with two buffers; and the tile
# pass's shared parts removed one at a time (the backward built alongside
# changes too)
K5_VARIANTS = {
    "as built": [],
    "one block, ring of 3": [
        ("constexpr int kFwdRing = 2;", "constexpr int kFwdRing = 3;"),
        ("kSmemPerSM / (kFwdSmemBytes + kSmemPerBlock) >= 2 ? 2 : 1;",
         "1;"),
        ("                  Widths<128, 256>::kFwdSmemBytes == 109568 &&\n",
         ""),
        ("Widths<128, 256>::kFwdBlocks == 2",
         "Widths<128, 256>::kFwdBlocks == 1")],
    "no products": [
        ("      mma_bf16_16816(acc[2 * j], af, &bf[0]);\n"
         "      mma_bf16_16816(acc[2 * j + 1], af, &bf[2]);",
         "      acc[2 * j][0] += __uint_as_float(af[0] ^ bf[0]);\n"
         "      acc[2 * j + 1][0] += __uint_as_float(af[1] ^ bf[2]);")],
    "no weight loads": [("      load_chunk<C, F>(p, ahead % kChunks,",
                         "      if (false) load_chunk<C, F>(p, ahead % "
                         "kChunks,")],
    "no row loops": [("constexpr int kWarpRows = kTT / kTileWarps;",
                      "constexpr int kWarpRows = 0;")],
    # the row loops, the forward's and the backward's alike
    "row loops unrolled 4": [
        ("#pragma unroll 2\n      for (int i",
         "#pragma unroll 4\n      for (int i")],
    "rsqrtf": [("  rs = 1.f / sqrtf(", "  rs = rsqrtf(")],
}
MIN_BLOCKS = "static constexpr int kMinBlocks = D == 128 ? 2 : 4;"
D8_HEADS = "static constexpr int kHeads = D == 8             ? 4"
# K8's forward at D = 8: as built 4 heads a block (32 channels), four
# blocks an SM
D8_VARIANTS = {
    "8 heads at D 8, 3 blocks": [
        (D8_HEADS, D8_HEADS.replace("4", "8")),
        (MIN_BLOCKS, MIN_BLOCKS.replace("? 2 :", "? 2 : D == 8 ? 3 :"))],
    "8 heads at D 8, 2 blocks": [
        (D8_HEADS, D8_HEADS.replace("4", "8")),
        (MIN_BLOCKS, MIN_BLOCKS.replace("? 2 :", "? 2 : D == 8 ? 2 :"))],
    "4 heads at D 8, 3 blocks": [
        (MIN_BLOCKS, MIN_BLOCKS.replace("? 2 :", "? 2 : D == 8 ? 3 :"))],
}
K8_VARIANTS = {
    "as built": [],
    "serial search": [
        ("  if (warp == 0) key_range_warp(wb, V, t0, nt, s_range);",
         "  if (threadIdx.x == 0) key_range(wb, V, t0, nt, s_range);")],
    # all 8 heads of 16 (128 channels): two blocks an SM, and the lse
    # store takes one float a head
    "8 heads a block": [
        ("constexpr int kFwdChannels = 64;",
         "constexpr int kFwdChannels = 128;"),
        ("static_assert(FwdTc<16>::kHeads == 4,",
         "static_assert(FwdTc<16>::kHeads == 8,"),
        (MIN_BLOCKS, "static constexpr int kMinBlocks = 2;")],
    "3 blocks an SM": [(MIN_BLOCKS, "static constexpr int kMinBlocks = 3;")],
    "no exps": [("ex2(fmaf(sj[", "(fmaf(sj[")],
    "no products": [('#include "mma.cuh"', FAKE_MMA),
                    ("          mma_bf16_16816(", "          fake_mma(")],
}


def k5_inputs(B: int, V: int):
    g = torch.Generator().manual_seed(5)
    r = lambda *s, scale=0.1: torch.randn(*s, generator=g) * scale
    C, F = ffn.KERNEL_C, ffn.KERNEL_F
    x, attn = (r(B, V, C, scale=1.0).bfloat16() for _ in range(2))
    ws = [r(C, C), r(C), 1 + r(C), r(C), r(C, F), r(F), r(F, C), r(C),
          1 + r(C), r(C)]
    nv = torch.full((B,), V, dtype=torch.int32)
    return [t.cuda() for t in (x, attn, *ws, nv)]


def main() -> None:
    heads = width_arg(__doc__.splitlines()[0])
    if not torch.cuda.is_available():
        raise SystemExit("probe_forwards: no CUDA GPU")
    print(probe.card())
    print(f"K8 in {heads[0]} heads of {heads[1]}")
    k5 = probe.build_variants(probe.K5_HEADER, K5_VARIANTS, OUT / "k5",
                              probe.K5_UNITS)
    variants = dict(K8_VARIANTS, **(D8_VARIANTS if heads[1] == 8 else {}))
    k8 = probe.build_variants("band_attention.cu", variants, OUT / "k8")
    print("K5 forward, bf16")
    probe.time_variants(k5, {
        f"{B}x{V}": (lambda a=k5_inputs(B, V): ffn.post_attention_block(*a))
        for B, V in ((4, 20480), (4, 8192), (1, 20480))})
    C = heads[0] * heads[1]
    for name, lib in k8.items():
        print(f"{name}: band_attention_fwd_tc_kernel<{heads[1]}, {C}> "
              + probe.resources(lib, f"band_attention_fwd_tc_kernelILi"
                                f"{heads[1]}ELi{C}E"))
    print("K8 forward with statistics, bf16")
    probe.time_variants(k8, {
        f"{what} {tuple(a[0].shape[:2])}":
            (lambda a=a: attention._forward(*a[:5], stats=True))
        for what, a in ((w, inputs(*lay, heads))
                        for w, lay in layouts().items())})


if __name__ == "__main__":
    main()
