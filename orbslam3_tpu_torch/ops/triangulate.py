"""DLT triangulation of two camera rays.

Counterpart of `orbslam3_tpu/ops/triangulate.py` (reference
src/GeometricTools.cc GeometricTools::Triangulate).  The default path
solves the inhomogeneous 4x3 DLT system by closed-form 3x3 normal
equations plus two steps of iterative refinement, as the JAX package does;
`triangulate_dlt_svd` is the exact homogeneous null-space solve, kept as
the oracle for tests.
"""

from __future__ import annotations

import torch


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _mtv(A, x):
    return torch.einsum("...ij,...i->...j", A, x)


def triangulate_dlt(ray1: torch.Tensor, ray2: torch.Tensor,
                    Tcw1_R: torch.Tensor, Tcw1_t: torch.Tensor,
                    Tcw2_R: torch.Tensor, Tcw2_t: torch.Tensor) -> torch.Tensor:
    """World xyz (..., 3) from two rays (..., 3) (any scale, z != 0) and the
    world->camera poses of their cameras."""
    A = _dlt_rows(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t)
    M = A[..., :, :3]
    b = -A[..., :, 3]
    H = torch.einsum("...ij,...ik->...jk", M, M)
    g = _mtv(M, b)
    # closed-form SPD 3x3 inverse (adjugate)
    a, b2, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b2 * f
    co02 = b2 * e - c * d
    co11 = a * f - c * c
    co12 = b2 * c - a * e
    co22 = a * d - b2 * b2
    det = a * co00 + b2 * co01 + c * co02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co01, co11, co12], -1),
        torch.stack([co02, co12, co22], -1),
    ], -2)

    def solve(rhs):
        return _mv(adj, rhs) * inv_det[..., None]

    X = solve(g)
    # two refinement steps against the original 4x3 system (the normal
    # equations square the conditioning)
    for _ in range(2):
        X = X + solve(_mtv(M, b - _mv(M, X)))
    # degenerate systems (parallel rays) give huge coordinates; keep them
    # finite, the callers' gates reject them
    return torch.clamp(X, -1e12, 1e12)


def _dlt_rows(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t):
    P1 = torch.cat([Tcw1_R, Tcw1_t[..., None]], dim=-1)  # (..., 3, 4)
    P2 = torch.cat([Tcw2_R, Tcw2_t[..., None]], dim=-1)

    def rows(ray, P):
        x = ray[..., 0] / ray[..., 2]
        y = ray[..., 1] / ray[..., 2]
        return x[..., None] * P[..., 2, :] - P[..., 0, :], \
            y[..., None] * P[..., 2, :] - P[..., 1, :]

    a0, a1 = rows(ray1, P1)
    a2, a3 = rows(ray2, P2)
    return torch.stack([a0, a1, a2, a3], dim=-2)  # (..., 4, 4)


def triangulate_dlt_svd(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t):
    """Exact homogeneous DLT via the 4x4 SVD (reference
    GeometricTools::Triangulate): the oracle for tests."""
    A = _dlt_rows(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t)
    _, _, Vh = torch.linalg.svd(A)
    X = Vh[..., 3, :]
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]
