"""Closed-form eigendecomposition of batched symmetric 3x3 matrices.

Port of ``geomae_tpu/ops/eig3.py`` (``pack_sym``, ``eigvals_sym6``,
``smallest_eigvec_sym6``, ``normal_and_curvature6`` and their [..., 3, 3]
forms) with the same arithmetic in the same order.  For a symmetric PSD
covariance the surface normal is the eigenvector of the smallest
eigenvalue and the curvature is the descending spectrum, normalised.  Matrices are packed as [..., 6]
(00, 11, 22, 01, 02, 12).

The normal's sign is that of the cross product of the row pair of
``A - lambda_min I`` whose cross has the largest norm (ties keep the
earlier pair), as in the JAX function: another formula would give the
same axis with other signs, and the pretrain loss is an MSE on the signed
normal.
"""
from __future__ import annotations

import torch

_EPS = 1e-20


def pack_sym(A: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> packed [..., 6] (00, 11, 22, 01, 02, 12)."""
    return torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
                        A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]], -1)


def eigvals_sym6(c: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of packed symmetric [..., 6], descending [..., 3]."""
    c = c.float()
    c00, c11, c22 = c[..., 0], c[..., 1], c[..., 2]
    c01, c02, c12 = c[..., 3], c[..., 4], c[..., 5]
    q = (c00 + c11 + c22) / 3.0
    a00, a11, a22 = c00 - q, c11 - q, c22 - q
    p2 = (a00 * a00 + a11 * a11 + a22 * a22
          + 2.0 * (c01 * c01 + c02 * c02 + c12 * c12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    b00, b11, b22 = a00 / p, a11 / p, a22 / p
    b01, b02, b12 = c01 / p, c02 / p, c12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    two_pi_3 = 2.0943951023931953
    e0 = q + 2.0 * p * torch.cos(phi)                 # largest
    e2 = q + 2.0 * p * torch.cos(phi + two_pi_3)      # smallest
    e1 = 3.0 * q - e0 - e2
    degenerate = p2 <= _EPS
    evals = torch.stack([e0, e1, e2], -1)
    return torch.where(degenerate[..., None], q[..., None].expand_as(evals),
                       evals)


def smallest_eigvec_sym6(c: torch.Tensor,
                         eval_min: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of packed symmetric
    [..., 6]: the cross product of the two most independent rows of
    ``A - lambda_min I``, normalised; (0, 0, 1) for a fully degenerate
    matrix (torch.svd of a zero matrix gives the identity's last
    column)."""
    c = c.float()
    m00 = c[..., 0] - eval_min
    m11 = c[..., 1] - eval_min
    m22 = c[..., 2] - eval_min
    m01, m02, m12 = c[..., 3], c[..., 4], c[..., 5]

    def cross(ax, ay, az, bx, by, bz):
        return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)

    c01 = cross(m00, m01, m02, m01, m11, m12)
    c02 = cross(m00, m01, m02, m02, m12, m22)
    c12 = cross(m01, m11, m12, m02, m12, m22)

    def n2(v):
        return v[0] * v[0] + v[1] * v[1] + v[2] * v[2]

    n01, n02, n12 = n2(c01), n2(c02), n2(c12)
    use02 = n02 > n01
    bx = torch.where(use02, c02[0], c01[0])
    by = torch.where(use02, c02[1], c01[1])
    bz = torch.where(use02, c02[2], c01[2])
    bn = torch.maximum(n02, n01)
    use12 = n12 > bn
    bx = torch.where(use12, c12[0], bx)
    by = torch.where(use12, c12[1], by)
    bz = torch.where(use12, c12[2], bz)
    bn = torch.maximum(n12, bn)
    ok = bn > 1e-12
    inv = 1.0 / torch.sqrt(torch.clamp(bn, min=_EPS))
    zero = torch.zeros_like(bx)
    return torch.stack([torch.where(ok, bx * inv, zero),
                        torch.where(ok, by * inv, zero),
                        torch.where(ok, bz * inv, zero + 1.0)], -1)


def normal_and_curvature6(cov6: torch.Tensor, eps: float = 1e-9):
    """(normal [..., 3], curvature [..., 3]) from packed covariances."""
    evals = torch.clamp(eigvals_sym6(cov6), min=0.0)      # PSD clamp
    normal = smallest_eigvec_sym6(cov6, evals[..., 2])
    curv = evals + eps
    return normal, curv / curv.sum(-1, keepdim=True)


# [..., 3, 3] forms, for tests and callers off the hot path


def eigvals3x3_sym(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], descending [..., 3]."""
    return eigvals_sym6(pack_sym(A.float()))


def smallest_eigvec3x3_sym(A: torch.Tensor,
                           eval_min: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3,
    3]."""
    return smallest_eigvec_sym6(pack_sym(A.float()), eval_min)


def normal_and_curvature(cov: torch.Tensor, eps: float = 1e-9):
    """(normal [..., 3], curvature [..., 3]) of symmetric PSD [..., 3, 3]
    covariances: the unit vector of the smallest eigenvalue and the
    descending spectrum + eps, normalised to sum 1 (the reference's
    ``cal_regular_voxel_nor_and_curv``)."""
    return normal_and_curvature6(pack_sym(cov), eps)
