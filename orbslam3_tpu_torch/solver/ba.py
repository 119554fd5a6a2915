"""The COO bundle adjustment problem and the closed-form 3x3 blocks of the
bundle adjustment solvers.

Counterpart of `BAProblem`, `_spd_inv3` and `_chol3` in
`orbslam3_tpu/solver/ba.py`.  The grid solver (`solver/ba_grid.py`) and the
visual-inertial BA (`solver/vi_ba.py`) use the blocks on their points;
`mapping.gather_window_problem_bank` fills a `BAProblem` for the
visual-inertial BA.  The visual COO solvers (PCG and dense Schur) are not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BAProblem(NamedTuple):
    """Fixed-capacity visual BA problem with COO observations.  Stereo
    observations carry obs_ur >= 0; the optional per-camera position priors
    are the GNSS-constrained BA's."""
    R: torch.Tensor                 # (K, 3, 3) R_cw
    t: torch.Tensor                 # (K, 3)
    cam_fixed: torch.Tensor         # (K,) bool: pose held constant
    cam_valid: torch.Tensor         # (K,) bool
    X: torch.Tensor                 # (P, 3)
    pt_valid: torch.Tensor          # (P,) bool
    obs_cam: torch.Tensor           # (O,) int
    obs_pt: torch.Tensor            # (O,) int
    obs_uv: torch.Tensor            # (O, 2)
    obs_inv_sigma2: torch.Tensor    # (O,)
    obs_valid: torch.Tensor         # (O,) bool
    obs_ur: Optional[torch.Tensor] = None    # (O,) stereo right-u; -1 = mono
    prior_pos: Optional[torch.Tensor] = None  # (K, 3) prior camera centre
    prior_w: Optional[torch.Tensor] = None    # (K,) information; 0 = none


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
