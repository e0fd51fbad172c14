"""DeltaXYZWLHR box decoding (code size 9 with velocities).

Port of ``geomae_tpu/models/box_coder.py:decode``: xy scaled by the anchor
BEV diagonal, z (bottom -> centre) by anchor height, dims as log ratios,
rotation and velocities as plain differences.
"""
from __future__ import annotations

import torch


def decode(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """deltas, anchors [..., 9] -> boxes [..., 9] with z at the bottom."""
    xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = deltas[..., :7].unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    out = [xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
           torch.exp(wt) * wa, torch.exp(lt) * la, hg, rt + ra]
    if deltas.shape[-1] > 7:
        out += [deltas[..., 7] + anchors[..., 7],
                deltas[..., 8] + anchors[..., 8]]
    return torch.stack(out, -1)
