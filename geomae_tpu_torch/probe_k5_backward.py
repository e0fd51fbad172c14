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

    python -m geomae_tpu_torch.probe_k5_backward phase_a

runs, from the repo's root, ``chip_smoke.py``'s phase A rows of the bf16
backward at every (C, F) on the pretrain encoder's tokens (at the C of
``--channels`` alone where given), three seeds at C 384 and more
(``phase_a_rule``): the three rules of ``compare_grads``,
the kernel's, the plain version's and the plain version's with its
products on the tensor cores (``tensor_core_grads``) distances from the
f64 computation, and the planted faults.

    python -m geomae_tpu_torch.probe_k5_backward resources

prints ptxas's registers and spill bytes for each of K5's kernels at
every width (``probe.resources``, from the package's build log).

    python -m geomae_tpu_torch.probe_k5_backward parent --parent DIR

holds K5's kernels at the widths a parent checkout took to its build
(``DIR/build/geomae_tpu_torch/libgeomae_kernels_*.so``, built there
first): their SASS (``probe.compare_sass``; the widths of ``NEW_WIDTHS``
left out), then K5 and its backward in bf16 at ``PARENT_TIMED`` on [4,
8192] tokens, the two libraries in turns in one process, four turns.

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

import argparse
import contextlib
import re
from pathlib import Path

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


@contextlib.contextmanager
def tensor_core_products():
    """Each ``@`` on f32 tensors taken on the tensor cores instead: bf16
    operands, f32 accumulation in the card's adders, a bf16 result, as
    the kernels' products (cuBLAS; no reduced-precision reduction).
    Exact only where the product's operands hold bf16 values and its
    result is rounded to bf16 at once, as in the tile pass."""
    mm, reduced = torch.Tensor.__matmul__, \
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.Tensor.__matmul__ = lambda a, b: torch.matmul(
        a.bfloat16(), b.bfloat16()).float()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = mm
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced


def tensor_core_grads(args) -> list:
    """The ten parameter gradients of the plain backward with the tile
    pass's products on the tensor cores (``tensor_core_products``; each
    is rounded to bf16 at once) and the weight pass's f32 sums over the
    tokens as they are."""
    with tensor_core_products():
        dz1, _, xm, da1, h, dz2, *vectors = \
            ffn.post_attention_block_backward_tile_plain(*args)
    dwo, dw1, dw2 = ffn.weight_grads_plain(args[1], dz1, xm, da1, h, dz2,
                                           args[12])
    dbo, ds1, dt1, db1, db2, ds2, dt2 = vectors
    return [dwo, dbo, ds1, dt1, dw1, db1, dw2, db2, ds2, dt2]


def grad_bounds(args) -> list:
    """F5's rule for each of the ten parameter gradients (module
    docstring): (2^-8 + n 2^-24) sum_j |t_j| per element, f64."""
    B, V = args[0].shape[:2]
    with f64_sums():
        mags = ffn.post_attention_block_backward_plain(*args,
                                                       absolute=True)[2:]
    return [(U_BF16 + B * V * U_F32) * m for m in mags]


# The precision rule beside F5's: in each f32 parameter gradient at most
# LOW_BITS_SHARE of the elements end in LOW_BITS zero bits.  A gradient
# rounded to bf16 (8 significant bits) ends so in all of them, which F5's
# rule does not see (2^-9 relative, under its 2^-8 sum |terms|).  A sum
# over hundreds of tokens needs more than 8 bits, even a sum of bf16
# values (dt1, db2: about 8 + log2(tokens) bits, and fewer rounding
# events in a pairwise sum), so few of its elements end so
# (``tests/test_torch_port_ffn.py`` holds the plain version under the
# limit at 500 to 3,548 tokens; on the H100, phase A's kernel and plain
# version at [4, 8192] ended so in at most 0.004 of a gradient's elements
# at every width, ``phase_a`` below).
LOW_BITS = 16
LOW_BITS_SHARE = 0.25


def low_bits_shares(grads) -> list:
    """Each f32 gradient's share of elements whose LOW_BITS lowest bits
    are all 0."""
    mask = (1 << LOW_BITS) - 1
    return [float(((g.float().contiguous().view(torch.int32) & mask) == 0)
                  .float().mean()) for g in grads]


def rule_shares(got, exact, bounds) -> list:
    """Each parameter gradient's largest error against ``exact`` over
    its bound, elementwise (1 is the limit)."""
    return [round(float(((g.double() - e.double()).abs()
                         / b.clamp_min(1e-300)).max()), 3)
            for g, e, b in zip(got, exact, bounds)]


def dropped_token(args, rows: int = 1) -> list:
    """``args`` with the cotangent of one real token zeroed, or of the
    ``rows`` real tokens of the aligned tile that holds it: the backward
    then drops those tokens' terms from every parameter gradient (their
    dz2, da1, dxm and dz1 are 0).  The token is the one with the largest
    |dy| of the first sample's real rows."""
    dy = args[13].clone()
    n = int(args[12][0])
    t = int(dy[0, :n].float().abs().amax(-1).argmax()) // rows * rows
    dy[0, t:min(t + rows, n)] = 0
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


def phase_a_rule(seeds: int = 3, channels=None) -> None:
    """Phase A's bf16 K5 backward rows (``chip_smoke.phase_a``: its two
    rules, the distances from the f64 computation and the planted faults)
    at every (C, F) of KERNEL_WIDTHS (of C in ``channels`` where given) on
    the pretrain encoder's tokens, with ``seeds`` seeds of the tokens and
    weights at C 384 and more: the readings behind
    ``chip_smoke.K5_GRAD_TOL``."""
    import chip_smoke
    from .config import apply_overrides, geomae_pretrain_nus

    key = ("post_attention_block_backward", "")
    chip_smoke.TOL[key] = {torch.bfloat16: chip_smoke.TOL[key][
        torch.bfloat16]}
    pcfg, dev, failures = geomae_pretrain_nus(), torch.device("cuda"), []
    seed = chip_smoke.SEED
    for C in sorted({c for c, _ in ffn.KERNEL_WIDTHS}):
        if channels and C not in channels:
            continue
        cfg = apply_overrides(pcfg, [f"sst.d_model={C}"])
        inputs = chip_smoke.pretrain_inputs(cfg, dev)
        for F in sorted(f for c, f in ffn.KERNEL_WIDTHS if c == C):
            for s in range(seed, seed + (seeds if C >= 384 else 1)):
                chip_smoke.SEED = s     # phase_a's generator reads it
                chip_smoke.phase_a(chip_smoke.sst_width(cfg, C, 8, F),
                                   f"K5 at ({C}, {F}), seed {s}", inputs,
                                   [key], {}, failures)
    chip_smoke.SEED = seed
    print(f"failures: {failures}")


# the widths this package adds to a parent's (parent), and the old widths
# timed against the parent: the shipped one and the widest
NEW_WIDTHS = tuple((C, k * C) for C in (640, 768, 1024) for k in (1, 2, 3, 4))
PARENT_TIMED = ((128, 256), (512, 1024))
# K5's kernels by the head of their mangled names, before the widths
KERNELS = {"f32 forward": "post_attention_kernelI",
           "f32 backward": "post_attention_bwd_kernelIf",
           "bf16 forward": "post_attention_fwd_tc_kernelI",
           "tile pass": "post_attention_bwd_tile_kernelI",
           "weight pass": "wgrad_kernelI"}
OLD_WIDTH = re.compile(r"(?:post_attention\w*|wgrad_kernel)<(?:float, )?"
                       + "".join(f"(?!{c}, {f}>)" for c, f in NEW_WIDTHS)
                       + r"\d+, \d+>$")


def resources() -> None:
    lib = _cuda.library()
    for C, F in ffn.KERNEL_WIDTHS:
        print(f"({C}, {F}): " + "; ".join(
            f"{name} {probe.resources(lib, f'{head}Li{C}ELi{F}E')}"
            for name, head in KERNELS.items()))


def against_parent(parent: Path) -> None:
    libs = probe.parent_and_change(parent)
    probe.compare_sass(libs, OLD_WIDTH, "K5's kernels at the parent's widths")
    calls = {}
    for C, F in PARENT_TIMED:
        a = [t.cuda() for t in test_case(C, F, 4, 8192, (8192,) * 4)]
        calls[f"K5 ({C}, {F})"] = lambda a=a: ffn.post_attention_block(
            *a[:13])
        calls[f"backward ({C}, {F})"] = \
            lambda a=a: ffn.post_attention_block_backward(*a)
    probe.time_variants({k: probe._load(v) for k, v in libs.items()}, calls,
                        turns=4)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?",
                    choices=("noise", "phase_a", "resources", "parent"))
    ap.add_argument("--parent", type=Path,
                    help="parent: the checkout whose kernels to compare")
    ap.add_argument("--channels", type=int, nargs="+",
                    help="phase_a: the C to run (default every one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k5_backward: no CUDA GPU")
    if args.what == "phase_a":
        import chip_smoke
        chip_smoke.startup()
        phase_a_rule(channels=args.channels)
        return
    print(probe.card())
    if args.what == "noise":
        noise()
        return
    if args.what == "resources":
        return resources()
    if args.what == "parent":
        return against_parent(args.parent)
    libs = probe.build_variants(probe.K5_HEADER, VARIANTS, OUT,
                                probe.K5_UNITS)
    bwd = ffn.post_attention_block_backward
    probe.time_variants(libs, {
        f"{B}x{V}": (lambda a=inputs(B, V): bwd(*a))
        for B, V in ((4, 20480), (4, 8192))})


if __name__ == "__main__":
    main()
