"""Windowed attention over window-sorted tokens (plain PyTorch).

Port of ``geomae_tpu/ops/attention.py:band_attention``.  Tokens are
sorted by window id (``ops/windows.py``), so each window is a contiguous
run and attention is exact per window.  The JAX function reaches the
keys through a fixed band of neighbouring tiles; here each chunk of
queries takes the exact key range that covers its windows (two sorted
searches), which holds windows of any size.

Dtype points follow the TPU kernel this is the plain version of
(``pallas_attention_qkv._fwd_kernel``): scores and the softmax sum in
f32, the probabilities cast to v's dtype for the value product, f32
accumulation.  Padding rows (``win_id == INT32_MAX``) and rows with no
visible key return 0.
"""
from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


def band_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   win_id: torch.Tensor, key_valid: torch.Tensor | None = None,
                   scale: float | None = None,
                   q_chunk: int = 1024) -> torch.Tensor:
    """q, k, v: [B, V, H, D] in window-sorted order; win_id int32 [B, V]
    ascending per row with INT32_MAX padding last; key_valid bool [B, V].
    ``scale`` defaults to 1/sqrt(D).  Returns [B, V, H, D] in v's dtype."""
    B, V, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.zeros_like(v)
    n_real = (win_id != INT32_MAX).sum(1).tolist()
    for b in range(B):
        w = win_id[b]
        kv = (torch.ones_like(w, dtype=torch.bool) if key_valid is None
              else key_valid[b])
        for q0 in range(0, n_real[b], q_chunk):
            q1 = min(q0 + q_chunk, n_real[b])
            ks = int(torch.searchsorted(w, w[q0:q0 + 1]))
            ke = int(torch.searchsorted(w, w[q1 - 1:q1], right=True))
            s = torch.einsum("qhd,khd->hqk", q[b, q0:q1].float(),
                             k[b, ks:ke].float()) * scale
            mask = (w[q0:q1, None] == w[None, ks:ke]) & kv[None, ks:ke]
            nonempty = mask.any(-1)
            s = s.masked_fill(~mask, float("-inf"))
            m = torch.where(nonempty[None, :, None],
                            s.amax(-1, keepdim=True), 0.0)
            p = torch.exp(s - m)
            lsum = p.sum(-1).clamp_min(1e-20)                  # [H, q]
            o = torch.einsum("hqk,khd->qhd", p.to(v.dtype).float(),
                             v[b, ks:ke].float())
            o = o / lsum.t()[..., None]
            out[b, q0:q1] = torch.where(nonempty[:, None, None], o,
                                        0.0).to(v.dtype)
    return out
