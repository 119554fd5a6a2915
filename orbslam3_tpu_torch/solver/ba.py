"""Closed-form 3x3 blocks of the bundle adjustment solvers.

Counterpart of `_spd_inv3` and `_chol3` in `orbslam3_tpu/solver/ba.py`;
the grid solver (`solver/ba_grid.py`) uses both on its point blocks.  The
COO bundle adjustment with its PCG and dense Schur solves is not ported
yet.
"""

from __future__ import annotations

import torch


def _spd_inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of SPD 3x3 blocks via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co01, co11, co12], -1),
        torch.stack([co02, co12, co22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _chol3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form Cholesky of SPD 3x3 blocks (lower L, A = L L^T)."""
    eps = 1e-12
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = torch.sqrt(torch.clamp_min(a11, eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp_min(a22 - l21 * l21, eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp_min(a33 - l31 * l31 - l32 * l32, eps))
    z = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, z, z], -1),
                        torch.stack([l21, l22, z], -1),
                        torch.stack([l31, l32, l33], -1)], -2)
