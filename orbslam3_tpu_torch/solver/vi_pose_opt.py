"""Visual-inertial pose optimization of a single frame.

Counterpart of `orbslam3_tpu/solver/vi_pose_opt.py`:
  * `vi_pose_optimization`, PoseInertialOptimizationLastKeyFrame (reference
    src/Optimizer.cc:3447-3845): the frame's 15-dof state [pose, velocity,
    bias] against unary monocular reprojection edges (Huber sqrt(5.991), 4
    rounds with chi2 re-classification), the inertial edge to the fixed last
    keyframe and the bias random walk edges;
  * `vi_pose_optimization_last_frame`, PoseInertialOptimizationLastFrame
    (:3846-4276): [previous frame, current frame] jointly, the previous
    constrained by its marginalized prior (ConstraintPoseImu), ending with
    the Schur marginalization of the previous state (:2882-2963) into the
    next frame's prior.

Visual Jacobians are analytic, inertial ones from `torch.func.jacfwd` on
the local update.  Gauss-Newton runs a fixed 4 x 5 schedule (the JAX
`fori_loop` is a Python loop) and solves with the unrolled Cholesky of
`ops/smallsolve` as the JAX package does.  Nothing is read back to the host:
the Cholesky factors and the inverse take their `_ex` form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cameras, lie, smallsolve
from . import robust
from .inertial import PreintFactor, factor_residual, info_from_cov, jacobian, select
from .vi_ba import STATE_DIM, apply_delta


class VIPoseResult(NamedTuple):
    Rwb: torch.Tensor
    pwb: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    H: torch.Tensor  # (15,15) final Gauss-Newton Hessian (frame prior)


class VIPosePrior(NamedTuple):
    """Marginalized 15-dof frame prior (reference ConstraintPoseImu,
    include/G2oTypes.h:705, carried as Frame::mpcpi)."""
    Rwb: torch.Tensor   # linearization state
    pwb: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor
    H: torch.Tensor     # (15,15) information


def _chol(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky_ex(A).L


def _factor_weights(factor: PreintFactor):
    """Square roots of the inertial and bias random walk informations of a
    one-row factor stack."""
    eye9 = torch.eye(9, dtype=factor.C.dtype, device=factor.C.device)
    eye6 = torch.eye(6, dtype=factor.C.dtype, device=factor.C.device)
    L9 = _chol(info_from_cov(factor.C[0, :9, :9]) + eye9 * 1e-12)
    Lb = _chol(torch.linalg.inv_ex(factor.C[0, 9:15, 9:15] + eye6 * 1e-12).inverse)
    return L9, Lb


def _visual_terms(X, uv, inv_sigma2, cam_model, cam_params, Rcb, tcb, Rwb, pwb, mask,
                  use_robust: bool, delta_h: float):
    """Residuals, Jacobians wrt [dtheta, dp] (Rwb' = Rwb Exp(dth):
    dXb/ddth = hat(Xb), dXb/dp = -Rbw), weights, chi2 and camera points."""
    Rbw = Rwb.T
    Xb = (X - pwb) @ Rbw.T
    Xc = Xb @ Rcb.T + tcb
    e = uv - cameras.project(cam_model, cam_params, Xc)
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)
    n = X.shape[0]
    dXb = torch.cat([lie.hat(Xb), -Rbw.expand(n, 3, 3)], dim=-1)          # (n,3,6)
    J = -torch.einsum("nij,jk,nkl->nil", Jproj, Rcb, dXb)                 # (n,2,6)
    chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
    w_rob = robust.huber_weight(chi2, delta_h) if use_robust else 1.0
    w = inv_sigma2 * w_rob * mask * (Xc[:, 2] > 1e-2).to(torch.float32)
    return e, J, w, chi2, Xc


def vi_pose_optimization(Rwb0, pwb0, vel0, bias0, Rwb_kf, pwb_kf, vel_kf, bias_kf,
                         factor: PreintFactor, X, uv, inv_sigma2, valid,
                         cam_model: str, cam_params, Rcb, tcb, gravity,
                         rounds: int = 4, its_per_round: int = 5,
                         chi2_th: float = robust.CHI2_MONO) -> VIPoseResult:
    """Optimize the current frame's body state against the fixed last
    keyframe.  `factor` holds one preintegration (a one-row stack) from the
    keyframe to this frame; X/uv are the matched map points and keypoints."""
    delta_h = chi2_th ** 0.5
    L9, Lb = _factor_weights(factor)
    f0 = select(factor, 0)
    eye = torch.eye(STATE_DIM, dtype=X.dtype, device=X.device)
    vis = lambda R, p, mask, rob: _visual_terms(X, uv, inv_sigma2, cam_model, cam_params,
                                                Rcb, tcb, R, p, mask, rob, delta_h)

    def inertial_terms(Rwb, pwb, vel, bias):
        def res(d):
            R2, p2, v2, b2 = apply_delta(Rwb, pwb, vel, bias, d)
            r9 = factor_residual(f0, Rwb_kf, pwb_kf, vel_kf, R2, p2, v2, bias_kf, gravity)
            return torch.cat([L9.T @ r9, Lb.T @ (b2 - bias_kf)])

        z = torch.zeros(STATE_DIM, dtype=X.dtype, device=X.device)
        return res(z), jacobian(res, z)

    def visual_hessian(Jv, w):
        return torch.nn.functional.pad(torch.einsum("nik,n,nil->kl", Jv, w, Jv), (0, 9, 0, 9))

    Rwb, pwb, vel, bias = Rwb0, pwb0, vel0, bias0
    mask = valid.to(torch.float32)
    for rnd in range(rounds):
        use_robust = rnd < 2
        for _ in range(its_per_round):
            e, Jv, w, _, _ = vis(Rwb, pwb, mask, use_robust)
            bv = -torch.einsum("nik,n,ni->k", Jv, w, e)
            r_in, J_in = inertial_terms(Rwb, pwb, vel, bias)
            H = visual_hessian(Jv, w) + J_in.T @ J_in + eye * 1e-6
            b = torch.nn.functional.pad(bv, (0, 9)) - J_in.T @ r_in
            dx = smallsolve.solve_psd(H, b)
            R2, p2, v2, b2 = apply_delta(Rwb, pwb, vel, bias, dx)
            Rwb, pwb, vel, bias = lie.normalize_rotation(R2), p2, v2, b2
        _, _, _, chi2, Xc = vis(Rwb, pwb, mask, use_robust)
        mask = (valid & (chi2 <= chi2_th) & (Xc[:, 2] > 1e-2)).to(torch.float32)

    _, Jv, w, _, _ = vis(Rwb, pwb, mask, False)
    _, J_in = inertial_terms(Rwb, pwb, vel, bias)
    H = visual_hessian(Jv, w) + J_in.T @ J_in
    inl = mask > 0
    return VIPoseResult(Rwb=Rwb, pwb=pwb, vel=vel, bias=bias, inliers=inl,
                        n_inliers=torch.sum(inl.to(torch.int32)), H=H)


def _state_diff(Rwb, pwb, vel, bias, prior: VIPosePrior):
    """15-dof local difference estimate (-) prior in apply_delta's
    parametrization (EdgePriorPoseImu, reference G2oTypes.h:731)."""
    return torch.cat([lie.log_so3(prior.Rwb.T @ Rwb), pwb - prior.pwb, vel - prior.vel,
                      bias - prior.bias])


def vi_pose_optimization_last_frame(Rwb0, pwb0, vel0, bias0, prior: VIPosePrior,
                                    factor: PreintFactor, X, uv, inv_sigma2, valid,
                                    cam_model: str, cam_params, Rcb, tcb, gravity,
                                    rounds: int = 4, its_per_round: int = 5,
                                    chi2_th: float = robust.CHI2_MONO):
    """Jointly optimize [previous (15), current (15)] with the previous
    state under its marginalized prior, the two linked by the
    preintegration and bias random walk edges, the visual edges on the
    current; then marginalize the previous state out of the 30x30 Hessian.
    Returns (VIPoseResult of the current frame, its VIPosePrior)."""
    delta_h = chi2_th ** 0.5
    S = STATE_DIM
    n_dim = 2 * S
    L9, Lb = _factor_weights(factor)
    f0 = select(factor, 0)
    eye = torch.eye(S, dtype=X.dtype, device=X.device)
    Lp = _chol(0.5 * (prior.H + prior.H.T) + eye * 1e-6)
    vis = lambda R, p, mask, rob: _visual_terms(X, uv, inv_sigma2, cam_model, cam_params,
                                                Rcb, tcb, R, p, mask, rob, delta_h)

    def chain_terms(Rp, pp, vp, bp, Rc, pc, vc, bc):
        """Whitened [inertial (9), bias random walk (6), prior (15)]
        residuals and their Jacobian over the 30-dof joint update."""
        def res(d):
            R1, p1, v1, b1 = apply_delta(Rp, pp, vp, bp, d[:S])
            R2, p2, v2, b2 = apply_delta(Rc, pc, vc, bc, d[S:])
            r9 = factor_residual(f0, R1, p1, v1, R2, p2, v2, b1, gravity)
            rp = _state_diff(R1, p1, v1, b1, prior)
            return torch.cat([L9.T @ r9, Lb.T @ (b2 - b1), Lp.T @ rp])

        z = torch.zeros(n_dim, dtype=X.dtype, device=X.device)
        return res(z), jacobian(res, z)

    def visual_hessian(Jv, w):
        return torch.nn.functional.pad(torch.einsum("nik,n,nil->kl", Jv, w, Jv),
                                       (S, 9, S, 9))

    Rp, pp, vp, bp = prior.Rwb, prior.pwb, prior.vel, prior.bias
    Rc, pc, vc, bc = Rwb0, pwb0, vel0, bias0
    eye2 = torch.eye(n_dim, dtype=X.dtype, device=X.device)
    mask = valid.to(torch.float32)
    for rnd in range(rounds):
        use_robust = rnd < 2
        for _ in range(its_per_round):
            e, Jv, w, _, _ = vis(Rc, pc, mask, use_robust)
            bv = -torch.einsum("nik,n,ni->k", Jv, w, e)
            r_ch, J_ch = chain_terms(Rp, pp, vp, bp, Rc, pc, vc, bc)
            H = visual_hessian(Jv, w) + J_ch.T @ J_ch + eye2 * 1e-6
            b = torch.nn.functional.pad(bv, (S, 9)) - J_ch.T @ r_ch
            dx = smallsolve.solve_psd_blocked(H, b, bs=6)
            R1, p1, v1, b1 = apply_delta(Rp, pp, vp, bp, dx[:S])
            R2, p2, v2, b2 = apply_delta(Rc, pc, vc, bc, dx[S:])
            Rp, pp, vp, bp = lie.normalize_rotation(R1), p1, v1, b1
            Rc, pc, vc, bc = lie.normalize_rotation(R2), p2, v2, b2
        _, _, _, chi2, Xc = vis(Rc, pc, mask, use_robust)
        mask = (valid & (chi2 <= chi2_th) & (Xc[:, 2] > 1e-2)).to(torch.float32)

    # the final 30x30 Hessian, then the previous state marginalized out
    _, Jv, w, _, _ = vis(Rc, pc, mask, False)
    _, J_ch = chain_terms(Rp, pp, vp, bp, Rc, pc, vc, bc)
    H = visual_hessian(Jv, w) + J_ch.T @ J_ch
    Hpp = H[:S, :S] + eye * 1e-6
    Hpc = H[:S, S:]
    H_marg = H[S:, S:] - Hpc.T @ torch.linalg.solve_ex(Hpp, Hpc).result
    inl = mask > 0
    res = VIPoseResult(Rwb=Rc, pwb=pc, vel=vc, bias=bc, inliers=inl,
                       n_inliers=torch.sum(inl.to(torch.int32)), H=H_marg)
    return res, VIPosePrior(Rwb=Rc, pwb=pc, vel=vc, bias=bc, H=0.5 * (H_marg + H_marg.T))
