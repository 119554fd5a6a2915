"""Pose-only optimization (motion-only BA).

Counterpart of `orbslam3_tpu/solver/pose_opt.py` (parity target
Optimizer::PoseOptimization, src/Optimizer.cc:765-1067): one SE3 pose,
unary reprojection edges, Huber sqrt(5.991) for the first two rounds,
edges re-classified by chi2 after each round.  All edges are evaluated
batched; Gauss-Newton with a fixed schedule (the JAX `lax.fori_loop`
becomes a Python loop: 4 rounds x 3 iterations = 12 steps), the inlier
set carried as a mask.  Pose is Tcw with the left-multiplicative update
Exp(dx) * Tcw, dx = [rho, phi].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cameras, lie, smallsolve
from . import robust


class PoseOptResult(NamedTuple):
    R: torch.Tensor        # (3,3) optimized R_cw
    t: torch.Tensor        # (3,) optimized t_cw
    inliers: torch.Tensor  # (N,) bool final inlier mask
    n_inliers: torch.Tensor
    chi2: torch.Tensor     # (N,) final per-edge chi2


def _reproj_residual_jac(cam_model, cam_params, R, t, X, uv):
    """Residual e = uv - proj(R X + t) and Jacobian de/d[rho, phi] (left-
    multiplicative) for all points: X (N,3), uv (N,2) -> (N,2), (N,2,6)."""
    Xc = lie.se3_apply(R, t, X)
    e = uv - cameras.project(cam_model, cam_params, Xc)
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)  # (N,2,3)
    # dXc/drho = I, dXc/dphi = -hat(Xc)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[0], 3, 3)
    dXc = torch.cat([eye, -lie.hat(Xc)], dim=-1)  # (N, 3, 6)
    J = -(Jproj @ dXc)
    return e, J, Xc


def pose_optimization(R0, t0, X, uv, inv_sigma2, valid,
                      cam_model: str, cam_params,
                      rounds: int = 4, its_per_round: int = 3,
                      chi2_th: float = robust.CHI2_MONO,
                      min_depth: float = 1e-2) -> PoseOptResult:
    """Optimize Tcw against fixed world points.

    X: (N,3) world points; uv: (N,2) observations; inv_sigma2: (N,) octave
    information; valid: (N,) bool.  Returns optimized pose + inliers.
    Stays on the device: no value is read back to the host.
    """
    delta_huber = chi2_th ** 0.5
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)

    def gn_step(R, t, mask, use_robust):
        e, J, _ = _reproj_residual_jac(cam_model, cam_params, R, t, X, uv)
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
        w = robust.huber_weight(chi2, delta_huber) if use_robust else 1.0
        w = w * inv_sigma2 * mask
        # one Gram contraction for the whole normal system:
        # G = [J | e]^T W [J | e] (7x7), H = G[:6,:6], b = -G[:6,6]
        Je = torch.cat([J, e[..., None]], dim=-1)  # (N, 2, 7)
        G = torch.einsum("nik,n,nil->kl", Je, w, Je)
        H = G[:6, :6] + eye6 * 1e-6
        dx = smallsolve.solve_psd(H, -G[:6, 6])
        dR, dt = lie.se3_exp(dx)
        R2, t2 = lie.se3_compose(dR, dt, R, t)
        return lie.normalize_rotation(R2), t2

    R, t = R0, t0
    mask = valid.to(torch.float32)
    for rnd in range(rounds):
        use_robust = rnd < 2  # reference drops the kernel from round 3
        for _ in range(its_per_round):
            R, t = gn_step(R, t, mask, use_robust)
        e, _, Xc = _reproj_residual_jac(cam_model, cam_params, R, t, X, uv)
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
        depth_ok = Xc[..., 2] > min_depth
        mask = (valid & (chi2 <= chi2_th) & depth_ok).to(torch.float32)

    e, _, _ = _reproj_residual_jac(cam_model, cam_params, R, t, X, uv)
    chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
    inl = mask > 0
    return PoseOptResult(R=R, t=t, inliers=inl,
                         n_inliers=torch.sum(inl.to(torch.int32)), chi2=chi2)
