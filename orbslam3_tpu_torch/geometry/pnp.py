"""Robust PnP: batched RANSAC pose from 3D-2D correspondences, the DLT solver.

Counterpart of `orbslam3_tpu/geometry/pnp.py` (parity target: reference
MLPnPsolver, src/MLPnPsolver.cpp; RANSAC parameters at src/Tracking.cc:839).
Every RANSAC hypothesis is a linear DLT P6P solve (SVD of the stacked
projection equations), all hypotheses evaluated in one batch, followed by the
robust pose optimizer (`solver/pose_opt`) on the winner's inlier set.  The
maximum-likelihood part of MLPnP, the per-observation measurement covariance,
is carried by `inv_sigma2` (the octave noise model) in the hypothesis scoring
and in the refinement.  Relocalization uses `geometry/mlpnp.py`; this solver
is the simpler stand-in the JAX package keeps beside it.

The two sample sets (half the budget of `sample`-point sets, half of lean
7-point sets) are an argument, as in `geometry/twoview.reconstruct` and
`geometry/mlpnp.solve_mlpnp`: JAX draws them from a key split in two, and
torch cannot reproduce that draw.  Without them they come from
`torch.multinomial` with an explicit generator.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import cameras, lie
from ..solver import pose_opt


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _dlt_p6p(X: torch.Tensor, xn: torch.Tensor):
    """Linear pose from >= 6 points: X (..., S, 3) world, xn (..., S, 2)
    normalized image coordinates.  Hartley-normalized DLT; R orthogonalized
    by the exact SVD projection (a raw DLT estimate is far from orthogonal)."""
    c = torch.mean(X, dim=-2, keepdim=True)
    Xc_ = X - c
    rms = torch.sqrt(torch.mean(torch.sum(Xc_ ** 2, dim=-1), dim=-1) + 1e-12)
    s = (math.sqrt(3.0) / rms)[..., None, None]
    Xh = torch.cat([Xc_ * s, torch.ones_like(X[..., :1])], dim=-1)        # (..., S, 4)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                       # (..., 2S, 12)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    Pn = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 4))
    # denormalize: X_norm = s (X - c)  =>  P = Pn @ [[sI, -s c], [0, 1]]
    M = Pn[..., :3] * s
    p3 = Pn[..., 3] - lie._mv(M, c[..., 0, :])
    det = lie.det3(M)
    scale = torch.sign(det) * torch.pow(torch.abs(det) + 1e-20, 1.0 / 3.0)
    scale = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
    return lie.normalize_rotation_svd(M / scale[..., None, None]), p3 / scale[..., None]


def sample_sizes(iterations: int, sample: int):
    """((sets, points) of the `sample`-point half, (sets, points) of the lean
    half): lean 7-point sets keep an all-inlier chance at 40-50% outliers
    (0.5^7 against 0.5^12 per draw) that a 12-only sampler loses."""
    lean = max(min(7, sample), 6)
    n12 = iterations // 2
    return (n12, sample), (iterations - n12, lean)


def solve_pnp(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
              cam_model: str, cam_params, idx=None,
              generator: torch.Generator | None = None,
              iterations: int = 256, sample: int = 12, chi2_th: float = 5.991,
              min_inliers: int = 30, inv_sigma2=None) -> PnPResult:
    """X (N, 3) world points matched to uv (N, 2) pixels; RANSAC + refine.

    `idx`: the pair of sample index sets, shaped as `sample_sizes` says;
    drawn with `generator`, uniformly over the valid points, when absent.
    Hypotheses are scored with a loosened gate (4x chi2) so that near-miss
    poses still collect their support; the pose optimizer then re-selects
    inliers at the strict threshold.  `inv_sigma2` (N,): per-observation
    inverse pixel variance, 1 by default."""
    n = X.shape[0]
    dev = X.device
    cam_params = torch.as_tensor(cam_params, dtype=torch.float32, device=dev)
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones(n, dtype=torch.float32, device=dev)
    rays = cameras.unproject(cam_model, cam_params, uv)
    xn = rays[:, :2] / rays[:, 2:3]
    if idx is None:
        w = valid.to(torch.float32) + 1e-9
        idx = [torch.multinomial(w, sets * pts, replacement=True,
                                 generator=generator).reshape(sets, pts)
               for sets, pts in sample_sizes(iterations, sample)]
    poses = [_dlt_p6p(X[i.long()], xn[i.long()]) for i in idx]
    Rs = torch.cat([p[0] for p in poses])
    ts = torch.cat([p[1] for p in poses])

    Xc = torch.einsum("hij,nj->hni", Rs, X) + ts[:, None, :]              # (H, N, 3)
    e = uv[None] - cameras.project(cam_model, cam_params, Xc)
    chi2 = torch.sum(e * e, dim=-1) * inv_sigma2[None]
    inl = (chi2 < 4.0 * chi2_th) & valid[None] & (Xc[..., 2] > 0.01)
    best = torch.argmax(torch.sum(inl.to(torch.int32), dim=1)).reshape(1)
    res = pose_opt.pose_optimization(
        Rs.index_select(0, best)[0], ts.index_select(0, best)[0], X, uv, inv_sigma2,
        inl.index_select(0, best)[0], cam_model, cam_params, rounds=3, its_per_round=6,
        chi2_th=chi2_th)
    return PnPResult(success=res.n_inliers >= min_inliers, R=res.R, t=res.t,
                     inliers=res.inliers, n_inliers=res.n_inliers)
