"""How far the two SST attention routes' bf16 encoder layers lie from the
f32 layer, and how far a faulty attention would, on one CUDA GPU.

    python -m geomae_tpu_torch.probe_routes [--csrc DIR] [--width C,D]

Builds one full-width encoder layer of ``geomae_finetune_nus()`` (or,
with ``--width``, of its SST at C channels in heads of D, FFN 2 C: any
width of the kernels) on the
``qkv`` route (K6) and on the ``band`` route (Linears, then K8) with the
same seeded weights (``route_stacks``, which ``chip_smoke.py``'s route
check builds from too), on the fine-tune step's layer-0 windows at batch
4 (``synthetic_batch``, seed 0), and runs it in f32 and bf16 on four
seeded inputs (seed 7 is the route check's).  It prints, as a share of
the kernels' bf16 bound (2e-2 + 2e-2 relative, ``share``), the largest
error of each route's bf16 layer against its f32 layer and against the
other route, and of the band route's bf16 layer with a fault put into its
attention: the output rounded to fewer mantissa bits than bf16's 7, or
the last key of every window dropped.  ``--csrc`` builds the kernels from
another tree's ``csrc/`` (with the same C entry points), so two trees'
kernels can be held in one call.

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from . import probe
from .ops import _cuda
from .probe_qkv import width

SEEDS = (7, 8, 9, 10)
TOL = (2e-2, 2e-2)
# the attention output's stored mantissa bits under a precision fault
FAULT_BITS = (6, 5, 3)


def route_stacks(cfg, g: torch.Generator, device) -> dict:
    """{route: one SST block in eval mode} on the qkv and band routes with
    the same weights from ``g``; the in-projection biases are drawn too
    (``init_weights`` zeroes them), so both routes add them."""
    from .config import replace
    from .models.detector import init_weights
    from .models.sst import SSTStack

    stacks = {}
    for route in ("qkv", "band"):
        stack = SSTStack(replace(cfg.sst, attention_impl=route), 1,
                         device=device)
        if stacks:
            stack.load_state_dict(stacks["qkv"].state_dict())
        else:
            init_weights(stack, g)
            with torch.no_grad():
                for name, p in stack.named_parameters():
                    if name.endswith("in_proj_bias"):
                        p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        stacks[route] = stack.eval()
    return stacks


def share(got: torch.Tensor, want: torch.Tensor, tol=TOL) -> float:
    """The largest error of ``got`` as a share of atol + rtol |want|; inf
    where ``got`` is not finite."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - w).abs() / (tol[0] + tol[1] * w.abs())).max())


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t`` rounded to nearest even with ``bits`` stored mantissa bits
    (bf16 has 7, fp8 e4m3 3), in t's dtype."""
    i = t.float().view(torch.int32)
    drop = 23 - bits
    half = (1 << (drop - 1)) - 1 + ((i >> drop) & 1)
    return ((i + half) & -(1 << drop)).view(torch.float32).to(t.dtype)


def last_key_dropped(layer: dict) -> dict:
    """``layer`` with the last token of every window no valid key."""
    w = layer["win_id"]
    last = torch.ones_like(w, dtype=torch.bool)
    last[:, :-1] = w[:, 1:] != w[:, :-1]
    return {**layer,
            "key_valid_sorted": layer["key_valid_sorted"] & ~last}


def at_width(cfg, C: int, heads: int):
    """``cfg`` with its SST at C channels in ``heads`` heads, FFN 2 C."""
    from .config import apply_overrides

    return apply_overrides(cfg, [f"sst.d_model={C}", f"sst.nhead={heads}",
                                 f"sst.dim_feedforward={2 * C}"])


def layer_inputs(cfg, dev):
    """The fine-tune batch's shift data (batch 4, seed 0) on ``dev``."""
    from .models.detector import extract_scene
    from .models.sst import prepare_shift_data
    from .ops.windows import make_layouts
    from .train.finetune import synthetic_batch

    b = synthetic_batch(cfg, 4, seed=0, device=dev)
    t = extract_scene(cfg, b["points"], b["point_valid"]).table
    return prepare_shift_data(make_layouts(t.coords, t.valid, cfg.sst,
                                           cfg.voxel), t.valid, cfg.sst)


def readings(cfg, layer: dict, seed: int, dev) -> dict:
    """{what: share of the bf16 bound} for one seed."""
    g = torch.Generator().manual_seed(seed)
    stacks = route_stacks(cfg, g, dev)
    B, V = layer["win_id"].shape
    x = torch.randn(B, V, cfg.sst.d_model, generator=g).to(dev)
    enc = {r: m[0].encoder_list[0] for r, m in stacks.items()}
    bf, f32 = torch.bfloat16, torch.float32
    with torch.no_grad():
        out = {(r, dt): e(x.to(dt), layer) for r, e in enc.items()
               for dt in (f32, bf)}
        faults = {}
        attn = enc["band"].win_attn
        for bits in FAULT_BITS:
            hook = attn.register_forward_hook(
                lambda m, args, o, bits=bits: round_mantissa(o, bits))
            faults[f"{bits}-bit attention"] = enc["band"](x.to(bf), layer)
            hook.remove()
        faults["last key dropped"] = enc["band"](x.to(bf),
                                                 last_key_dropped(layer))
    got = {"band vs qkv": share(out["band", bf], out["qkv", bf]),
           "band vs f32": share(out["band", bf], out["band", f32]),
           "qkv vs f32": share(out["qkv", bf], out["qkv", f32])}
    got.update({f"band, {k}, vs f32": share(v, out["band", f32])
                for k, v in faults.items()})
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="build the kernels from this csrc/ directory")
    ap.add_argument("--width", type=width, default=(128, 8),
                    help="C,D: C channels in heads of D (default 128,16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_routes: no CUDA GPU")
    from .apis import geomae_finetune_nus

    print(probe.card())
    if args.csrc is not None:         # every kernel from that tree
        saved = _cuda.CSRC
        _cuda.CSRC = args.csrc.resolve()
        path = _cuda.BUILD_DIR.parent / "probe_routes" / "libother.so"
        _cuda.build(path)
        _cuda.CSRC = saved
        _cuda._lib = probe._load(path)
        print(f"kernels from {args.csrc}")
    cfg = at_width(geomae_finetune_nus(), *args.width)
    print(f"SST at C {cfg.sst.d_model} in {cfg.sst.nhead} heads, FFN "
          f"{cfg.sst.dim_feedforward}")
    dev = torch.device("cuda")
    layer = layer_inputs(cfg, dev)["layers"][0]
    for seed in SEEDS:
        got = readings(cfg, layer, seed, dev)
        print(f"seed {seed}, shares of the bf16 bound: " + ", ".join(
            f"{k} {v:.3f}" for k, v in got.items()))


if __name__ == "__main__":
    main()
