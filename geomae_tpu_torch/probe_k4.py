"""Where the time of K4 (``expand_rows``) goes, on one CUDA GPU.

    python -m geomae_tpu_torch.probe_k4

Builds ``csrc/targets.cu`` several times into ``build/probe_k4/``: as it
is, without the scan of the keys (every cell empty: the probe round and
the stores alone), and with spans of 256 and 1,024 cells; then times
``expand_rows`` on each build at the pretrain step's [4, 20480, 13] ->
[4, 160001, 13], beside ``zero_`` of the grid alone and ``zero_`` +
``index_copy_`` of the occupied rows, with ``probe.cuda_ms`` (20 calls
after 3 warm-up, enqueued behind a device spin, every build twice, in
turns).

Raises without a CUDA GPU: its numbers are the card's.
"""
from __future__ import annotations

import torch

from . import probe
from .ops import _cuda, targets

OUT = _cuda.BUILD_DIR.parent / "probe_k4"
SCAN = "  for (int r = lo + threadIdx.x; r < hi; r += kThreads) {"
SPAN = "constexpr int kSpan = 512;"
VARIANTS = {
    "as built": [],
    "no scan": [(SCAN, SCAN.replace("r < hi", "r < lo"))],
    "span 256": [(SPAN, SPAN.replace("512", "256"))],
    "span 1024": [(SPAN, SPAN.replace("512", "1024"))],
}


def inputs():
    """(feats [4, 20480, 13], key, n_cells) of the pretrain step's targets,
    as ``mae.compute_targets_batch`` builds them."""
    from .config import geomae_pretrain_nus
    from .models import mae
    from .ops.voxelize import build_scene_batch
    from .train.pretrain import synthetic_batch

    cfg = geomae_pretrain_nus()
    dev = torch.device("cuda")
    b = synthetic_batch(cfg, cfg.data.batch_size, seed=0, device=dev)
    scene = build_scene_batch(b["points"], b["point_valid"], cfg.voxel,
                              cfg.caps.max_voxels)
    V = scene.table.valid.shape[1]
    mu, vals4 = mae._centered_vals4(scene, V)
    sums = targets.slot_outer_segment_sum(vals4, scene.slot_sort,
                                          scene.table.point2voxel,
                                          cfg.voxel.num_slots_low, V)
    feats, key = mae._moment_feats(scene.table, cfg.voxel, sums, mu)
    return feats, key, cfg.voxel.grid_size[0] * cfg.voxel.grid_size[1]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_k4: no CUDA GPU")
    print(probe.card())
    libs = probe.build_variants("targets.cu", VARIANTS, OUT)
    feats, key, cells = inputs()
    B, V, C = feats.shape
    ok = key < cells
    print(f"{tuple(feats.shape)} -> {(B, cells + 1, C)}, "
          f"{int(ok.sum())} occupied cells")
    idx = (key.long() + (cells + 1) * torch.arange(
        B, device=key.device)[:, None])[ok]
    grid = torch.empty(B * (cells + 1), C, device=feats.device)
    src = feats[ok]
    probe.time_variants(libs, {
        "expand_rows": lambda: targets.expand_rows(feats, key, cells),
        "zero_": grid.zero_,
        "zero_ + index_copy_": lambda: grid.zero_().index_copy_(0, idx, src)})


if __name__ == "__main__":
    main()
