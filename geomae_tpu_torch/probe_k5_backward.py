"""Where the time of K5's bf16 backward goes, on one CUDA GPU.

    python -m geomae_tpu_torch.probe_k5_backward

Builds ``csrc/post_attention.cu`` (with ``segment.cu``, which holds the
error strings) several times into ``build/probe_k5/``: as it is, and with
one part of the per-tile pass removed (its row-wise epilogues, its
tensor-core products, its weight loads), then times
``post_attention_block_backward`` in bf16 on each build at the fine-tune
step's [4, 20480] and the pretrain encoder's [4, 8192] tokens with CUDA
events (``probe.cuda_ms``: 20 calls after 3 warm-up, enqueued behind a
device spin, every build twice, in turns).  A build with a part removed
computes garbage; only its time means something.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import torch

from . import probe
from .ops import _cuda, ffn

OUT = _cuda.BUILD_DIR.parent / "probe_k5"
# the edits reach the tile pass's shared device functions (chunk_product,
# product_pass) too, so the forward built alongside computes garbage as well
EPILOGUE = ("      product_pass<kRing, kTileChunks>(p, pass, A, lda, more, "
            "s_w, cnt, acc);")
MMA = ("      mma_bf16_16816(acc[2 * j], af, &bf[0]);\n"
       "      mma_bf16_16816(acc[2 * j + 1], af, &bf[2]);")
LOAD = "      load_chunk(p, ahead % kChunks,"
# each product's operands still loaded, so the compiler keeps the loads
NO_MMA = ("      acc[2 * j][0] += __uint_as_float(af[0] ^ bf[0]);\n"
          "      acc[2 * j + 1][0] += __uint_as_float(af[1] ^ bf[2]);")
NO_EPILOGUE = EPILOGUE + "\n      if (true) continue;"
NO_LOAD = "      if (false) load_chunk(p, ahead % kChunks,"
VARIANTS = {
    "as built": [],
    "no epilogues": [(EPILOGUE, NO_EPILOGUE)],
    "no products": [(MMA, NO_MMA)],
    "no weight loads": [(LOAD, NO_LOAD)],
    "products only": [(EPILOGUE, NO_EPILOGUE), (LOAD, NO_LOAD)],
    "epilogues only": [(MMA, NO_MMA), (LOAD, NO_LOAD)],
}


def inputs(B: int, V: int):
    g = torch.Generator().manual_seed(5)
    r = lambda *s, scale=0.1: torch.randn(*s, generator=g) * scale
    C, F = ffn.KERNEL_C, ffn.KERNEL_F
    x, attn, dy = (r(B, V, C, scale=1.0).bfloat16() for _ in range(3))
    ws = [r(C, C), r(C), 1 + r(C), r(C), r(C, F), r(F), r(F, C), r(C),
          1 + r(C), r(C)]
    nv = torch.full((B,), V, dtype=torch.int32)
    return [t.cuda() for t in (x, attn, *ws, nv, dy)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_k5_backward: no CUDA GPU")
    print(probe.card())
    libs = probe.build_variants("post_attention.cu", VARIANTS, OUT)
    bwd = ffn.post_attention_block_backward
    probe.time_variants(libs, {
        f"{B}x{V}": (lambda a=inputs(B, V): bwd(*a))
        for B, V in ((4, 20480), (4, 8192))})


if __name__ == "__main__":
    main()
