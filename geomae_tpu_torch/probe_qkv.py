"""K6's and K7's bf16 projections on one CUDA GPU: the weight-gradient
chunk size, and where K7's parameter-gradient noise comes from.

    python -m geomae_tpu_torch.probe_qkv [--width C,D]         # chunk sizes
    python -m geomae_tpu_torch.probe_qkv grads [--width C,D]   # K7's noise
    python -m geomae_tpu_torch.probe_qkv parent --parent DIR   # the old widths
    python -m geomae_tpu_torch.probe_qkv rule [--widths C,D ...]  # K7's rule
    python -m geomae_tpu_torch.probe_qkv resources             # registers

``--width`` takes C channels in heads of D, any width of the kernels
(``attention_qkv.kernel_takes``); the default is the shipped 128 in heads of
16.

Chunk sizes: times ``qkv_project`` and ``qkv_project_backward`` at [4,
20480] and [4, 8192] (bf16 rows and weights, so the wrappers cast
nothing) with ``probe.cuda_ms`` (20 calls after 3 warm-up, enqueued
behind a device spin, every setting twice, in turns), the weight
gradients over chunks of ``attention_qkv.wgrad_chunk_rows`` rows (about
2 x SMs blocks) and over fixed chunks of 512, 1,024 and 2,048 rows.

Gradient noise: bf16 K7's six parameter gradients against the plain
backward on ``k7_case`` inputs, each as a share of the bound of the
``cuda`` tests (``check_grads``: 1e-3 of max(its own largest value, 0.1
of the largest of the six); the key bias's gradient is analytically 0,
so its bound is the floor), at [1, 777], [2, 1024] and [4, 8192]; then
the largest |dbk| of K7, of the plain backward and of K7 with dbk
replaced by dbq or dbv (the query's or the value's column sums: a
planted fault) over ``dbk_bound``, the rule that holds dbk to 0 in
``test_band_attention_qkv_backward_one_sample``.  Then,
with ``qkv_project`` in the package: how many bf16 roundings of q, k
and v differ from those of projections summed in f64, for the kernel,
a build of it that sums each k16 product in IEEE f32 (``IEEE_K16``; the
edit reaches the resident kernel of C 128-512 alone),
the plain version (an f32 GEMM) and the f64 projections themselves;
and the shares through each mix of K7's stages (those projections, the
attention backward, the projections' backward, each a kernel or plain),
so the share can be laid to a stage, each also with its |dbk| over
``dbk_bound``; last, the kernel's and the IEEE
k16 build's times at [4, 8192], twice in turns.  The first two lines alone
also run against a package without ``qkv_project`` (one whose bf16 K7
is one kernel).

The old widths against another checkout of the package (``parent``,
``--parent DIR``: a checkout whose kernels are built, ``DIR/build/
geomae_tpu_torch/libgeomae_kernels_*.so``): the SASS of K6 / K7's and
K8's kernels at every width but C 640, 768 and 1024 (``OLD_WIDTH``; the
projections' streamed kernels are the wide C's alone) in both libraries
(``cuobjdump -sass``, names demangled, the anonymous namespace and
addresses dropped), K8's forward and backward, f32 and
bf16, at the width of any K8 kernel whose SASS differs, then K6, K7
and the projections, bf16 and f32, on ``k7_case(4, 8192)`` at C 128 in 8
heads and C 256 in 8, with the two libraries in turns in one process
(``probe.time_variants``, four turns).

K7's bf16 rule at every width (``rule``, or at ``--widths``): at [2,
1024] and [4, 8192] (``k7_case``, seeds 0-2) for every C and head width
the kernels take, K7's six
parameter gradients against the plain backward's, and each of them
against the plain backward computed with f64 values and sums at the same
bf16 rounding points (``f64_grads``), as shares of ``check_grads``' bound
(``grad_shares``); then K7 on a cotangent with 1 or 16 rows from the
real row of the largest |dO| zeroed (``dropped_rows``) against the plain
backward: the faults a rule must fail; last, per width the largest
share of each reading but the key bias's (the smallest of the faults').
``wgrad_tol`` is the rule those readings set.

``resources``: ptxas's registers and spill bytes (``probe.resources``,
from the package's build log) of K8's five kernels (f32 forward and
backward, the D prologue in bf16, the bf16 forward and backward) and of
f32 K6 and K7 at every width the kernels take, then of the bf16
projections' three kernels at every C.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import argparse
import contextlib
import re
from pathlib import Path

import numpy as np
import torch

from . import probe, probe_k5_backward
from .ops import _cuda, attention, attention_qkv

INT32_MAX = 2 ** 31 - 1
GRAD_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv")

# bf16 K7's parameter gradients against the plain backward, as shares of
# max(own, 0.1 x the largest of the six), by width, from ``rule``'s readings
# (H100 80GB HBM3, 700 W): K7 and the plain backward may each lie as far
# from the plain backward computed in f64 as those readings went, so the
# two as far as their sum, which each tolerance covers: at heads of 8 or
# more 5.30e-3 at C 128 (D 8; the plain backward alone 4.76e-3), 2.26e-3
# at 256, 2.8e-3 at 384 and 512; below 8 a head's gradients sum fewer
# channels and read more: 8.68e-3, 10.06e-3, 13.57e-3 and 12.35e-3 (D 1
# at every C).  K7 with one real row of dO dropped reads at least
# 13.3e-3 at heads of 8 or more and 19.3e-3 below 8, above each.  At C
# 640, 768 and 1024 (heads of 8 to 128, ``rule --widths``) K7 read up to
# 4.04e-3 / 4.08e-3 / 3.00e-3 from f64 and the plain backward up to
# 1.48e-3 / 2.41e-3 / 2.74e-3, both at most at D 8; their sums, 5.51e-3 /
# 6.48e-3 / 5.74e-3 (at D 8; 4.36e-3 / 2.61e-3 / 3.40e-3 at most at D 16
# to 128), set 6e-3 / 7e-3 / 6e-3, and one dropped row reads at least
# 13.7e-3 / 16.5e-3 / 20.0e-3.  Past these a bf16 rounding of the
# gradients (up to 2^-8 of an element's binade) is held by their
# precision (``probe_k5_backward.low_bits_shares``), not by this rule.
WGRAD_TOL = {128: 6e-3, 256: 3e-3, 384: 3e-3, 512: 3e-3, 640: 6e-3,
             768: 7e-3, 1024: 6e-3}
WGRAD_TOL_BELOW_8 = {128: 1e-2, 256: 1.2e-2, 384: 1.5e-2, 512: 1.4e-2}


def wgrad_tol(C: int, D: int) -> float:
    """bf16 K7's parameter-gradient tolerance at C in heads of D."""
    return (WGRAD_TOL_BELOW_8 if D < 8 else WGRAD_TOL)[C]


def calls(B: int, V: int, C: int = 128) -> dict:
    """{label: call} of the two wrappers on seeded bf16 rows of C
    channels, a padding suffix of a tenth of V."""
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device="cuda")
                            * sc).to(torch.bfloat16)
    x, pos = r(B, V, C), r(B, V, C)
    ws = [r(C, C, sc=C ** -0.5) if i % 2 == 0 else r(C, sc=0.1)
          for i in range(6)]
    win = torch.arange(V, device="cuda", dtype=torch.int32).div(
        100, rounding_mode="floor").expand(B, V).contiguous()
    win[:, V - V // 10:] = INT32_MAX
    ds = [r(B, V, C) for _ in range(3)]
    return {f"qkv_project [{B}, {V}]":
            lambda: attention_qkv.qkv_project(x, pos, *ws, win),
            f"qkv_project_backward [{B}, {V}]":
            lambda: attention_qkv.qkv_project_backward(x, pos, *ws[0::2],
                                                       *ds)}


def chunk_sizes(C: int) -> None:
    todo = {**calls(4, 20480, C), **calls(4, 8192, C)}
    sized = attention_qkv.wgrad_chunk_rows
    try:
        for turn in range(2):
            for n in (None, 512, 1024, 2048):
                attention_qkv.wgrad_chunk_rows = sized if n is None \
                    else lambda x, n=n: n
                name = "SM-sized chunks" if n is None else f"chunks of {n}"
                print(f"turn {turn} {name}: " + ", ".join(
                    f"{what} {probe.cuda_ms(fn):.4f} ms"
                    for what, fn in todo.items()))
    finally:
        attention_qkv.wgrad_chunk_rows = sized


def k7_case(B: int, V: int, seed: int = 0, C: int = 128):
    """bf16 K7's inputs on the card at C channels: (args, dout), args =
    (x, pos, wq, bq, wk, bk, wv, bv, win_id, key_valid).  Windows of
    1-144 tokens (a 12 x 12 window's most) with gaps in their ids over a
    padding suffix, a fifth of the keys invalid; f32 pos and weights (the
    wrapper casts them), bf16 x and cotangent, from a generator on the
    card."""
    rng = np.random.default_rng(B + V)
    win = np.full((B, V), INT32_MAX, np.int32)
    for b in range(B):
        n, ids, w = int(rng.integers(V // 2, V - 100)), [], 0
        while len(ids) < n:
            ids.extend([w] * int(rng.integers(1, 145)))
            w += 3
        win[b, :n] = ids[:n]
    kv = (rng.random((B, V)) > 0.2) & (win != INT32_MAX)
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    ws = [r(C, C, sc=C ** -0.5) if i % 2 == 0 else r(C, sc=0.1)
          for i in range(6)]
    x, pos = r(B, V, C).to(torch.bfloat16), r(B, V, C)
    dout = r(B, V, C).to(torch.bfloat16)
    ids = [torch.from_numpy(a).cuda() for a in (win, kv)]
    return [x, pos, *ws, *ids], dout


def grad_shares(got, want) -> str:
    """Each parameter gradient's largest error over the bound of the
    ``cuda`` tests' ``check_grads`` in bf16."""
    top = max(float(b.abs().max()) for b in want[1:])
    share = lambda a, b: float((a - b).abs().max()) / (
        1e-3 * max(float(b.abs().max()), 0.1 * top))
    return ", ".join(f"d{n} {share(a, b):.3f}"
                     for n, a, b in zip(GRAD_NAMES, got[1:], want[1:]))


@contextlib.contextmanager
def f64_sums():
    """``probe_k5_backward.f64_sums`` with f64 as the default dtype too,
    so the plain K7's zero-initialised sums widen with its values."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with probe_k5_backward.f64_sums():
            yield
    finally:
        torch.set_default_dtype(default)


def f64_grads(args, heads: int, out, dout) -> tuple:
    """The plain K7 (dx and the six parameter gradients) under
    ``f64_sums``: the function at its bf16 rounding points, computed
    closer to exact."""
    with f64_sums():
        return attention_qkv.band_attention_qkv_backward_plain(
            *args, heads, out, dout)


def dropped_rows(dout: torch.Tensor, win_id: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """``dout`` with ``rows`` rows zeroed from the real row (``win_id``
    not INT32_MAX) with the largest |dO| on: a planted fault."""
    flat = dout.reshape(-1, dout.shape[-1])
    mag = flat.float().abs().amax(-1)
    mag[win_id.reshape(-1) == INT32_MAX] = -1
    r = min(int(mag.argmax()), flat.shape[0] - rows)
    d = flat.clone()
    d[r:r + rows] = 0
    return d.view_as(dout)


def shares(got, want) -> list:
    """``grad_shares`` as numbers, the key bias's left out (it is held to
    0 by F3's rule)."""
    top = max(float(b.abs().max()) for b in want[1:])
    return [float((a - b).abs().max())
            / (1e-3 * max(float(b.abs().max()), 0.1 * top))
            for n, a, b in zip(GRAD_NAMES, got[1:], want[1:]) if n != "bk"]


def rule(widths=None, seeds=(0, 1, 2)) -> None:
    """bf16 K7's parameter gradients against the plain backward, both
    against it computed in f64, and with dropped rows, at ``widths``
    ((C, heads); every width by default)."""
    worst: dict = {}
    for C, D in ([w for w in attention.kernel_widths()
                  if attention_qkv.kernel_takes(w[0], w[0] // w[1])]
                 if widths is None else [(C, C // H) for C, H in widths]):
        for (B, V), seed in ((bv, s) for bv in ((2, 1024), (4, 8192))
                             for s in seeds):
            heads = C // D
            args, dout = k7_case(B, V, seed=seed, C=C)
            out, lse = attention_qkv._forward(*args, heads, stats=True)
            k7 = lambda d: attention_qkv.band_attention_qkv_backward(
                *args, heads, out, lse, d)
            got = k7(dout)
            want = attention_qkv.band_attention_qkv_backward_plain(
                *args, heads, out, dout)
            exact = f64_grads(args, heads, out, dout)
            at = f"[{B}, {V}] seed {seed} C {C}, D {D}"
            read = {"K7 against the plain backward": (got, want),
                    "K7 against f64": (got, exact),
                    "plain against f64": (want, exact)}
            for rows in (1, 16):
                read[f"K7 with {rows} rows of dO dropped against the "
                     "plain backward"] = (k7(dropped_rows(
                         dout, args[8], rows)), want)
            for what, (a, b) in read.items():
                print(f"{at} {what}: " + grad_shares(a, b))
                top = max(shares(a, b))
                key = (C, D, what)
                worst[key] = (min if "dropped" in what else max)(
                    worst.get(key, top), top)
    print("largest share of the five gradients but dbk (smallest for the "
          "dropped rows), by width:")
    for (C, D, what), v in worst.items():
        print(f"  C {C}, D {D} {what}: {v:.3f}")


def dbk_bound(dk: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Per channel c, the forward-error bound on a key-bias gradient whose
    exact value is 0, summed as sum_j rt(dk_jc) (each f32 dk_jc rounded to
    ``dtype``, then summed in f32 over the n = B x V rows): (u + n 2^-24)
    x sum_j |dk_jc|, u the unit roundoff of ``dtype`` (2^-8 in bf16,
    2^-24 in f32), dk the f32 cotangent of the keys [B, V, C] (derived in
    ``tests/test_torch_port_cuda.py::
    test_band_attention_qkv_backward_one_sample``)."""
    n = dk.shape[0] * dk.shape[1]
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    return (u + n * 2.0 ** -24) * dk.float().abs().sum((0, 1))


def dbk_shares(grads: dict, bound: torch.Tensor) -> str:
    """Each {label: K7's outputs}'s largest |dbk| over ``dbk_bound``."""
    i = GRAD_NAMES.index("bk") + 1
    return ", ".join(f"{label} {float((g[i].abs() / bound).max()):.3f}"
                     for label, g in grads.items())


def exact_project(x, pos, wq, bq, wk, bk, wv, bv, win_id):
    """``qkv_project_plain`` with the products summed in f64 (then
    rounded to f32 and to x's dtype): the projections as near to exact
    as their dtype points allow."""
    dt = x.dtype
    xp = x + pos.to(dt)
    real = (win_id != INT32_MAX)[..., None]
    return tuple(
        torch.where(real, (a.double() @ w.to(dt).double()).float().to(dt)
                    + b.to(dt), 0.0)
        for a, w, b in ((xp, wq, bq), (xp, wk, bk), (x, wv, bv)))


def ieee_project(lib):
    """``qkv_project`` through ``lib``, a build of the sources whose
    projection sums each k16 product in IEEE f32 (the ``IEEE_K16``
    edit)."""
    def f(x, pos, wq, bq, wk, bk, wv, bv, win_id):
        pos, ws = attention_qkv._kernel_inputs(
            "qkv_project", x, pos, (wq, bq, wk, bk, wv, bv), win_id)
        q, k, v = (torch.empty_like(x) for _ in range(3))
        B, V, _ = x.shape
        code = lib.geomae_qkv_project(
            x.data_ptr(), pos.data_ptr(), *[w.data_ptr() for w in ws],
            win_id.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), B,
            V, _cuda.stream(x))
        _cuda.check(code, "qkv_project (IEEE k16)")
        return q, k, v
    return f


# the projection's k loop with each k16 step's products summed on the
# tensor cores from 0, then added to the running sums in IEEE f32
MMA_STEP = """      mma_w<C, false>(acc[0], axp, sm.w[0], kk);
      mma_w<C, false>(acc[1], axp, sm.w[1], kk);
      mma_w<C, false>(acc[2], ax, sm.w[2], kk);
"""
IEEE_K16 = """      float part[3][kWarpCols / 8][4] = {};
      mma_w<C, false>(part[0], axp, sm.w[0], kk);
      mma_w<C, false>(part[1], axp, sm.w[1], kk);
      mma_w<C, false>(part[2], ax, sm.w[2], kk);
#pragma unroll
      for (int o = 0; o < 3; ++o)
#pragma unroll
        for (int nb = 0; nb < kWarpCols / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[o][nb][e] += part[o][nb][e];
"""


def stages(args, dout, out, projections: dict, heads: int) -> dict:
    """{label: K7's output} through each mix of the stages: the
    projections (``projections``: {name: function}), K8's or the plain
    attention backward (K8's on its own forward's out and statistics,
    the plain one on ``out``), the projections' backward kernel or plain
    version."""
    x, pos, wq, bq, wk, bk, wv, bv, win, kv = args
    B, V, C = x.shape
    h = (B, V, heads, C // heads)
    res = {}
    for proj, f in projections.items():
        q, k, v = (t.view(h) for t in f(*args[:9]))
        for bw in ("K8", "plain"):
            if bw == "K8":
                o8, l8 = attention._forward(q, k, v, win, kv, stats=True)
                d = attention.band_attention_fused_backward(
                    q, k, v, win, kv, o8, l8, dout.view(h))
            else:
                d = attention.band_attention_backward_plain(
                    q, k, v, win, kv, out.view(h), dout.view(h))
            d = [t.reshape(B, V, C).to(x.dtype).contiguous() for t in d]
            for pb in ("kernel", "plain"):
                fb = attention_qkv.qkv_project_backward if pb == "kernel" \
                    else attention_qkv.qkv_project_backward_plain
                res[f"projections {proj}, attention backward {bw}, "
                    f"projections' backward {pb}"] = fb(x, pos, wq, wk, wv,
                                                       *d)
    return res


def grads(C: int, heads: int) -> None:
    split = hasattr(attention_qkv, "qkv_project")
    projections = {}
    if split:
        lib = probe.build_variants(
            probe.QKV_HEADER, {"IEEE k16": [(MMA_STEP, IEEE_K16)]},
            _cuda.BUILD_DIR.parent / "probe_qkv",
            probe.QKV_UNITS)["IEEE k16"]
        projections = {"kernel": attention_qkv.qkv_project,
                       "IEEE k16": ieee_project(lib),
                       "plain": attention_qkv.qkv_project_plain,
                       "f64": exact_project}
    for B, V in ((1, 777), (2, 1024), (4, 8192)):
        args, dout = k7_case(B, V, C=C)
        out, lse = attention_qkv._forward(*args, heads, stats=True)
        want = attention_qkv.band_attention_qkv_backward_plain(
            *args, heads, out, dout)
        got = attention_qkv.band_attention_qkv_backward(*args, heads, out,
                                                        lse, dout)
        print(f"[{B}, {V}] K7 against the plain backward: "
              + grad_shares(got, want))
        bound = dbk_bound(attention_qkv.attention_grads_plain(
            *args, heads, out, dout)[1])
        dbk = GRAD_NAMES.index("bk") + 1
        plants = {f"K7 with dbk := d{n}": tuple(got[:dbk]) + (
            got[GRAD_NAMES.index(n) + 1],) + tuple(got[dbk + 1:])
            for n in ("bq", "bv")}
        print(f"[{B}, {V}] |dbk| over dbk_bound: " + dbk_shares(
            {"K7": got, "plain": want, **plants}, bound))
        if not split:
            continue
        ref = exact_project(*args[:9])
        print(f"[{B}, {V}] bf16 roundings of q, k, v unlike the f64 "
              "projections': " + "; ".join(
                  f"{name} " + ", ".join(
                      f"{n} {int((a != b).sum())}"
                      for n, a, b in zip("qkv", f(*args[:9]), ref))
                  for name, f in projections.items()))
        for label, got in stages(args, dout, out, projections,
                                 heads).items():
            print(f"[{B}, {V}] {label}: " + grad_shares(got, want)
                  + "; |dbk| over dbk_bound " + dbk_shares({"": got}, bound))
    timed = list(projections.items())[:2]     # the kernel, IEEE k16
    for turn in range(2 if split else 0):
        ms = [f"{name} {probe.cuda_ms(lambda: f(*args[:9])):.4f}"
              for name, f in timed]
        print(f"turn {turn} [{B}, {V}] ms (the wrapper's casts included): "
              + ", ".join(ms))


# K6 / K7's and K8's kernels at every width but C 640, 768 and 1024 (the
# qkv kernels' template arguments <C> or <C, D>, K8's <D, C> or <T, D, C>)
OLD_WIDTH = re.compile(r"(?:qkv\w*<(?!(?:640|768|1024)\b)\d+(?:, \d+)?>"
                       r"|band_attention_(?!qkv)\w*<(?:[\w:]+, )?"
                       r"\d+, (?!(?:640|768|1024)>)\d+>)$")
# the mangled names of K8's kernels at (D, C) (the prologue's in bf16) and
# of f32 K6 / K7's at (C, D)
K8_KERNELS = {"f32": "band_attention_kernelILi{D}ELi{C}E",
              "f32 backward": "band_attention_bwd_f32_kernelILi{D}ELi{C}E",
              "prologue": "band_attention_delta_kernelI13__nv_bfloat16Li{D}"
                          "ELi{C}E",
              "bf16": "band_attention_fwd_tc_kernelILi{D}ELi{C}E",
              "bf16 backward": "band_attention_bwd_tc_kernelILi{D}ELi{C}E"}
QKV_F32_KERNELS = {"K6 f32": "band_attention_qkv_kernelILi{C}ELi{D}E",
                   "K7 f32": "band_attention_qkv_bwd_kernelILi{C}ELi{D}E"}
# the bf16 projections' kernels at C: weights resident up to C 512, the
# contraction streamed above
PROJ_KERNELS = {"project": "qkv_project_kernelILi{C}E",
                "dx": "qkv_project_dx_kernelILi{C}E",
                "wgrad": "qkv_wgrad_kernelILi{C}E"}
PROJ_KERNELS_WIDE = {"project": "qkv_project_stream_kernelILi{C}E",
                     "dx": "qkv_project_dx_stream_kernelILi{C}E",
                     "wgrad": "qkv_wgrad_kernelILi{C}E"}


def resources() -> None:
    lib = _cuda.library()
    for C, D in attention.kernel_widths():
        kernels = dict(K8_KERNELS)
        if attention_qkv.kernel_takes(C, C // D):
            kernels.update(QKV_F32_KERNELS)
        if D > 256:       # the two passes' kernel (band_attention.cuh)
            kernels["bf16 backward"] = \
                "band_attention_bwd_wide_kernelILi{D}ELi{C}E"
        print(f"C {C}, D {D}: " + "; ".join(
            f"{name} {probe.resources(lib, head.format(C=C, D=D))}"
            for name, head in kernels.items()))
    for C in attention_qkv.KERNEL_CHANNELS:
        kernels = PROJ_KERNELS_WIDE if C > 512 else PROJ_KERNELS
        print(f"C {C} projections: " + "; ".join(
            f"{name} {probe.resources(lib, head.format(C=C))}"
            for name, head in kernels.items()))


def k8_calls(C: int, D: int) -> dict:
    """K8's forward and backward (the prologue and the kernel) at C in
    heads of D, f32 and bf16, on ``k7_case(4, 8192)``'s windows: {label:
    call}."""
    args, _ = k7_case(4, 8192, C=C)
    win, kv = args[8:]
    g = torch.Generator(device="cuda").manual_seed(4)
    calls = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, d = (torch.randn(4, 8192, C // D, D, generator=g,
                                  device="cuda").to(dt) for _ in range(4))
        out, lse = attention._forward(q, k, v, win, kv, stats=True)
        tag = f"K8 C {C}, D {D} {str(dt)[6:]}"
        calls[tag] = (lambda q=q, k=k, v=v: attention._forward(
            q, k, v, win, kv, stats=True))
        calls[f"{tag} backward"] = (
            lambda q=q, k=k, v=v, o=out, l_=lse, d=d:
            attention.band_attention_fused_backward(q, k, v, win, kv, o, l_,
                                                    d))
    return calls


def against_parent(parent: Path) -> None:
    libs = probe.parent_and_change(parent)
    differ = probe.compare_sass(
        libs, OLD_WIDTH, "K6 / K7's and K8's kernels at the parent's widths")
    todo = {}
    for name in differ:   # a K8 kernel whose SASS moved: its width timed
        m = re.search(r"band_attention_(?!qkv)\w*<(?:[\w:]+, )?(\d+), (\d+)>",
                      name)
        if m:
            todo.update(k8_calls(int(m[2]), int(m[1])))
    for C in (128, 256):
        args, dout = k7_case(4, 8192, C=C)
        for dt in (torch.bfloat16, torch.float32):
            a_, d_ = (args[0].to(dt), *args[1:]), dout.to(dt)
            out, lse = attention_qkv._forward(*a_, 8, stats=True)
            tag = f"C {C} {str(dt)[6:]}"
            todo[f"K6 {tag}"] = (lambda a_=a_: attention_qkv._forward(
                *a_, 8, stats=True))
            todo[f"K7 {tag}"] = (
                lambda a_=a_, o=out, l_=lse, d=d_:
                attention_qkv.band_attention_qkv_backward(*a_, 8, o, l_, d))
        todo.update({f"{k} C {C}": f for k, f in calls(4, 8192, C).items()})
    probe.time_variants({k: probe._load(v) for k, v in libs.items()}, todo,
                        turns=4)


def width(text: str) -> tuple:
    """``--width C,D``: (C, heads), at a width the kernels take."""
    C, D = (int(v) for v in text.split(","))
    if C % D or not attention_qkv.kernel_takes(C, C // D):
        raise argparse.ArgumentTypeError(
            f"--width {text}: C in {attention_qkv.KERNEL_CHANNELS}, D in "
            f"{attention.KERNEL_HEAD_DIMS}")
    return C, C // D


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?",
                    choices=("grads", "parent", "rule", "resources"))
    ap.add_argument("--parent", type=Path,
                    help="parent: the checkout whose kernels to compare")
    ap.add_argument("--width", type=width, default=(128, 8),
                    help="C,D: C channels in heads of D (default 128,16)")
    ap.add_argument("--widths", type=width, nargs="+",
                    help="rule: the widths C,D to run (default every one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_qkv: no CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(probe.card())
    if args.what == "parent":
        return against_parent(args.parent)
    if args.what == "rule":
        return rule(args.widths)
    if args.what == "resources":
        return resources()
    C, heads = args.width
    print(f"C {C} in {heads} heads of {C // heads}")
    grads(C, heads) if args.what == "grads" else chunk_sizes(C)


if __name__ == "__main__":
    main()
