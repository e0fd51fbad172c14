"""Where the time of K5's bf16 backward goes, on one CUDA GPU.

    python -m geomae_tpu_torch.probe_k5_backward

Builds K5's sources (``csrc/post_attention.cuh`` and the translation
units that include it, with ``segment.cu``, which holds the error
strings) several times into ``build/probe_k5/``: as they are, and with
one part of the per-tile pass removed (its row-wise loops, its
tensor-core products, its weight loads), then times
``post_attention_block_backward`` in bf16 on each build at the fine-tune
step's [4, 20480] and the pretrain encoder's [4, 8192] tokens with CUDA
events (``probe.cuda_ms``: 20 calls after 3 warm-up, enqueued behind a
device spin, every build twice, in turns).  A build with a part removed
computes garbage; only its time means something.

    python -m geomae_tpu_torch.probe_k5_backward noise

compares instead, at the ``cuda`` tests' bf16 cases (``NOISE_CASES``),
the kernel's ten parameter gradients and the plain version's (both on
the card) with the plain version computed with f64 values and sums at
the same bf16 rounding points (``f64_sums``), each as a share of the
earlier rule of the tests (1e-3 of max(its own largest, 0.1 x the
largest), which the plain version itself broke: F5) and of the rule that
replaced it (``grad_bounds``), with a planted fault (one token's terms
dropped, ``dropped_token``) under the new rule too.

The rule (``grad_bounds``, F5, after F3's ``probe_qkv.dbk_bound``): each
of the ten gradients is a sum over the B V token rows of terms that are
products of values rounded to bf16 at the JAX dtype points (``dz1``,
``xm``, ``da1``, ``h``, ``dz2``, ``dy`` and their f32 LayerNorm factors).
Two faithful computations (the kernel, the plain version, the f64 one)
round each such value from inputs that differ in their last f32 bits, so
now and then a rounding lands on the other side, which moves that term
by one bf16 ulp, at most 2^-7 of itself.  Such flips are rare, and the
rule gives them F3's budget: each rounded term within 2^-8 (half an ulp)
of the f64 one, over all terms.  A sum of n terms in f32, in any order,
is off by at most (n - 1) 2^-24 sum |terms|.  So per element

    |g - g_f64| <= (2^-8 + n 2^-24) sum_j |t_j|,

sum_j |t_j| the terms' absolute values summed in f64
(``post_attention_block_backward_plain(..., absolute=True)`` under
``f64_sums``), n = B V.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import contextlib
import sys

import torch

from . import probe
from .ops import _cuda, ffn

OUT = _cuda.BUILD_DIR.parent / "probe_k5"
# the edits reach the tile pass's shared device functions (chunk_product,
# product_pass) too, so the forward built alongside computes garbage as well
EPILOGUE = "static constexpr int kWarpRows = kTT / kTileWarps;"
MMA = ("      mma_bf16_16816(acc[2 * j], af, &bf[0]);\n"
       "      mma_bf16_16816(acc[2 * j + 1], af, &bf[2]);")
LOAD = "      load_chunk<C, F>(p, ahead % kChunks,"
# each product's operands still loaded, so the compiler keeps the loads
NO_MMA = ("      acc[2 * j][0] += __uint_as_float(af[0] ^ bf[0]);\n"
          "      acc[2 * j + 1][0] += __uint_as_float(af[1] ^ bf[2]);")
# the row-wise loops run no row; the products are still staged
NO_EPILOGUE = "static constexpr int kWarpRows = 0;"
NO_LOAD = "      if (false) load_chunk<C, F>(p, ahead % kChunks,"
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


# ((C, F), B, V, nv) of tests/test_torch_port_cuda.py's bf16 backward
# cases: the three that read above the rule at the wide FFNs (PR 15) and
# two that pass
NOISE_CASES = [((128, 512), 1, 777, (500,)), ((256, 1024), 1, 777, (500,)),
               ((256, 1024), 2, 1000, (613, 1000)),
               ((128, 256), 1, 777, (500,)), ((256, 512), 1, 777, (500,))]


def test_case(C: int, F: int, B: int, V: int, nv) -> list:
    """The bf16 arguments of ``tests/test_torch_port_cuda.ffn_case`` (seed
    5) with ``nv``, on the CPU."""
    g = torch.Generator().manual_seed(5)
    r = lambda *s, scale=0.1: torch.randn(*s, generator=g) * scale
    x, attn = (r(B, V, C, scale=1.0).bfloat16() for _ in range(2))
    ws = [r(C, C), r(C), 1 + r(C), r(C), r(C, F), r(F), r(F, C), r(C),
          1 + r(C), r(C)]
    dy = r(B, V, C, scale=1.0).bfloat16()
    return [x, attn, *ws, torch.tensor(nv, dtype=torch.int32), dy]


@contextlib.contextmanager
def f64_sums():
    """The plain versions with their f32 values and sums widened to f64
    (``Tensor.float`` returns f64 inside), at the same rounding points to
    the compute dtype: the function computed closer to exact."""
    widen = torch.Tensor.float
    torch.Tensor.float = lambda self: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = widen


U_BF16 = 2.0 ** -8     # a bf16 rounding's largest relative error
U_F32 = 2.0 ** -24


def f64_grads(args) -> list:
    """The ten parameter gradients of the plain backward under
    ``f64_sums`` (on the inputs' device)."""
    with f64_sums():
        return list(ffn.post_attention_block_backward_plain(*args)[2:])


def grad_bounds(args) -> list:
    """F5's rule for each of the ten parameter gradients (module
    docstring): (2^-8 + n 2^-24) sum_j |t_j| per element, f64."""
    B, V = args[0].shape[:2]
    with f64_sums():
        mags = ffn.post_attention_block_backward_plain(*args,
                                                       absolute=True)[2:]
    return [(U_BF16 + B * V * U_F32) * m for m in mags]


def rule_shares(got, exact, bounds) -> list:
    """Each parameter gradient's largest error against ``exact`` over
    its bound, elementwise (1 is the limit)."""
    return [round(float(((g.double() - e.double()).abs()
                         / b.clamp_min(1e-300)).max()), 3)
            for g, e, b in zip(got, exact, bounds)]


def dropped_token(args) -> list:
    """``args`` with the cotangent of one real token zeroed: the
    backward then drops that token's terms from every parameter gradient
    (its dz2, da1, dxm and dz1 are 0).  The token is the one with the
    largest |dy| of the first sample's real rows."""
    dy = args[13].clone()
    n = int(args[12][0])
    t = int(dy[0, :n].float().abs().amax(-1).argmax())
    dy[0, t] = 0
    return [*args[:13], dy]


def shares(got, ref) -> list:
    """Each parameter gradient's largest error against ``ref`` as a share
    of the bf16 rule of the ``cuda`` tests (``check_grads``)."""
    top = max(float(r.abs().max()) for r in ref[2:])
    return [round(float((g.cpu().double() - r.cpu().double()).abs().max())
                  / (1e-3 * max(float(r.abs().max()), 0.1 * top)), 3)
            for g, r in zip(got[2:], ref[2:])]


def noise() -> None:
    print("shares, (wo, bo, s1, t1, w1, b1, w2, b2, s2, t2):")
    for (C, F), B, V, nv in NOISE_CASES:
        on_card = [t.cuda() for t in test_case(C, F, B, V, nv)]
        exact, bounds = f64_grads(on_card), grad_bounds(on_card)
        kernel = ffn.post_attention_block_backward(*on_card)
        plain = ffn.post_attention_block_backward_plain(*on_card)
        fault = ffn.post_attention_block_backward(*dropped_token(on_card))
        print(f"  (C, F) {(C, F)}, B {B}, V {V}, nv {nv}: the earlier rule, "
              f"kernel against the plain {shares(kernel, plain)}; against "
              f"f64 sums: kernel {shares(kernel, [0, 0] + exact)}, plain "
              f"{shares(plain, [0, 0] + exact)}")
        print(f"    F5's rule against f64 sums: kernel "
              f"{rule_shares(kernel[2:], exact, bounds)}, plain "
              f"{rule_shares(plain[2:], exact, bounds)}, kernel with a "
              f"token dropped {rule_shares(fault[2:], exact, bounds)}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_k5_backward: no CUDA GPU")
    print(probe.card())
    if sys.argv[1:] == ["noise"]:
        noise()
        return
    libs = probe.build_variants(probe.K5_HEADER, VARIANTS, OUT,
                                probe.K5_UNITS)
    bwd = ffn.post_attention_block_backward
    probe.time_variants(libs, {
        f"{B}x{V}": (lambda a=inputs(B, V): bwd(*a))
        for B, V in ((4, 20480), (4, 8192))})


if __name__ == "__main__":
    main()
