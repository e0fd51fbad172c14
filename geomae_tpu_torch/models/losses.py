"""Detection losses, elementwise (mmdet semantics).

Port of ``geomae_tpu/models/losses.py``: sigmoid focal loss (gamma 2,
alpha 0.25) summed over classes, smooth L1 (beta 1/9) and the direction
classifier's softmax cross-entropy; the zoo's chamfer distance and
axis-aligned IoU loss.  Callers weight and divide by their average
factor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Per-anchor focal loss summed over classes; ``labels`` in
    ``[0, num_classes]``, ``num_classes`` being background (an all-zero
    target)."""
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes]
    onehot = onehot.to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * onehot
          + torch.log1p(torch.exp(-torch.abs(logits))))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return torch.sum(alpha_t * (1 - p_t) ** gamma * ce, -1)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


# --- auxiliary losses of the reference zoo (mmdet3d models/losses/) -------


def chamfer_distance(src: torch.Tensor, dst: torch.Tensor,
                     src_valid: torch.Tensor | None = None,
                     dst_valid: torch.Tensor | None = None):
    """Symmetric squared-L2 chamfer distance of padded point sets src [N,
    D] and dst [M, D] (``chamfer_distance.py``, masks for the ragged
    sets): (mean over src of its nearest dst, mean over dst of its nearest
    src), each over the valid points."""
    d2 = ((src[:, None] - dst[None]) ** 2).sum(-1)
    big = torch.tensor(1e9, dtype=d2.dtype, device=d2.device)
    s2d = (d2 if dst_valid is None
           else torch.where(dst_valid[None, :], d2, big)).amin(1)
    d2s = (d2 if src_valid is None
           else torch.where(src_valid[:, None], d2, big)).amin(0)

    def mean(x, m):
        if m is None:
            return x.mean()
        return torch.where(m, x, 0).sum() / m.sum().clamp_min(1)
    return mean(s2d, src_valid), mean(d2s, dst_valid)


def axis_aligned_iou_loss(pred: torch.Tensor,
                          target: torch.Tensor) -> torch.Tensor:
    """1 - IoU of axis-aligned 3D boxes [..., 6] (x1 y1 z1 x2 y2 z2)
    (``axis_aligned_iou_loss.py``)."""
    lt = torch.maximum(pred[..., :3], target[..., :3])
    rb = torch.minimum(pred[..., 3:], target[..., 3:])
    inter = torch.clamp(rb - lt, min=0).prod(-1)

    def vol(b):
        return torch.clamp(b[..., 3:] - b[..., :3], min=0).prod(-1)

    union = vol(pred) + vol(target) - inter
    return 1.0 - inter / torch.clamp(union, min=1e-8)
