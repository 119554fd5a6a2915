"""Grid-dense local bundle adjustment: the window problem as a (P, K)
observation grid instead of a COO list.

Counterpart of `orbslam3_tpu/solver/ba_grid.py` (parity target: reference
LocalBundleAdjustment, src/Optimizer.cc:1069-1360).  A window map point is
observed at most once per keyframe, so residuals and Jacobians broadcast
over the grid, the small block products are unrolled into (P, K) plane
arithmetic, the two large contractions (Hcc over p*r, the Schur term over
p*3) are batched matmuls, and the reduced camera system is solved by the
unrolled block Cholesky (`ops/smallsolve.solve_psd_blocked`).

Empty grid slots carry weight 0; fixed cameras carry zeroed camera
Jacobians and identity rows in the reduced system.  The LM accept/reject
stays on the device (`torch.where`), as the JAX `lax.scan` body does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cameras, lie, smallsolve
from . import robust
from .ba import _chol3, _spd_inv3


class GridBAProblem(NamedTuple):
    """Dense-window BA problem: one observation slot per (point, camera)."""
    R: torch.Tensor            # (K, 3, 3) R_cw
    t: torch.Tensor            # (K, 3)
    cam_fixed: torch.Tensor    # (K,) bool
    cam_valid: torch.Tensor    # (K,) bool
    X: torch.Tensor            # (P, 3)
    pt_valid: torch.Tensor     # (P,) bool
    uv: torch.Tensor           # (P, K, 2)
    inv_sigma2: torch.Tensor   # (P, K)
    valid: torch.Tensor        # (P, K) bool, slot occupied
    ur: torch.Tensor           # (P, K) stereo right-u, -1 = mono


def _hat_apply(A, x):
    """A @ hat(x) for A (..., r, 3), x (..., 3) -> (..., r, 3), unrolled."""
    x0, x1, x2 = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    c0 = A[..., 1] * x2 - A[..., 2] * x1
    c1 = -A[..., 0] * x2 + A[..., 2] * x0
    c2 = A[..., 0] * x1 - A[..., 1] * x0
    return torch.stack([c0, c1, c2], dim=-1)


def _camera_points(R, t, X):
    """Xc (P, K, 3) = R_k X_p + t_k."""
    return torch.einsum("kab,pb->pka", R, X) + t[None]


def _stereo_residual(prob, uvp, Xc, stereo_bf):
    z = torch.clamp_min(Xc[..., 2], 1e-6)
    ur_pred = uvp[..., 0] - stereo_bf / z
    has_d = prob.ur >= 0
    return torch.where(has_d, prob.ur - ur_pred, 0.0), has_d, z


def _grid_residuals(prob: GridBAProblem, R, t, X, cam_model, cam_params,
                    stereo_bf: float):
    """e (P,K,r), Xc (P,K,3) with r = 2 (mono) or 3 (stereo row)."""
    Xc = _camera_points(R, t, X)
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.uv - uvp
    if stereo_bf > 0.0:
        e3, _, _ = _stereo_residual(prob, uvp, Xc, stereo_bf)
        e = torch.cat([e, e3[..., None]], dim=-1)
    return e, Xc


def _grid_jacobians(prob: GridBAProblem, R, t, X, cam_model, cam_params,
                    stereo_bf: float):
    """e (P,K,r), Jc (P,K,r,6), Jp (P,K,r,3), all plane arithmetic."""
    Xc = _camera_points(R, t, X)
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.uv - uvp
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)   # (P,K,2,3)
    if stereo_bf > 0.0:
        e3, has_d, z = _stereo_residual(prob, uvp, Xc, stereo_bf)
        e = torch.cat([e, e3[..., None]], dim=-1)
        w3 = has_d.to(torch.float32)
        Jur = torch.stack([Jproj[..., 0, 0] * w3,
                           Jproj[..., 0, 1] * w3,
                           (Jproj[..., 0, 2] + stereo_bf / (z * z)) * w3], dim=-1)
        Jproj = torch.cat([Jproj, Jur[..., None, :]], dim=-2)
    # Jc = -Jproj @ [I | -hat(Xc)] = [-Jproj | Jproj @ hat(Xc)]
    Jc = torch.cat([-Jproj, _hat_apply(Jproj, Xc)], dim=-1)
    # Jp = -Jproj @ R[k], the contraction over 3 unrolled into planes
    Jp = -(Jproj[..., 0:1] * R[None, :, None, 0, :] +
           Jproj[..., 1:2] * R[None, :, None, 1, :] +
           Jproj[..., 2:3] * R[None, :, None, 2, :])
    return e, Jc, Jp


def _slot_mask(prob: GridBAProblem):
    return (prob.valid & prob.pt_valid[:, None] & prob.cam_valid[None, :]
            ).to(torch.float32)


def _weights(prob: GridBAProblem, e, chi2_th, use_robust):
    chi2 = torch.sum(e * e, dim=-1) * prob.inv_sigma2
    w_rob = robust.huber_weight(chi2, chi2_th ** 0.5) if use_robust else 1.0
    msk = _slot_mask(prob)
    return prob.inv_sigma2 * w_rob * msk, chi2, msk


def _huber_cost(chi2, delta):
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= delta, chi2, 2 * delta * e - delta * delta)


def _grid_cost(prob, R, t, X, cam_model, cam_params, chi2_th, use_robust,
               stereo_bf):
    e, _ = _grid_residuals(prob, R, t, X, cam_model, cam_params, stereo_bf)
    chi2 = torch.sum(e * e, dim=-1) * prob.inv_sigma2
    c = _huber_cost(chi2, chi2_th ** 0.5) if use_robust else chi2
    return torch.sum(c * _slot_mask(prob))


def _plane_outer(A, B, wA=None):
    """sum_i A[..., i, a] * B[..., i, b] -> (..., nA, nB), unrolled.

    A (..., r, nA), B (..., r, nB); wA optional (...,) weight folded into A."""
    r, nA = A.shape[-2], A.shape[-1]
    nB = B.shape[-1]
    rows = []
    for a in range(nA):
        cols = []
        for b in range(nB):
            s = A[..., 0, a] * B[..., 0, b]
            for i in range(1, r):
                s = s + A[..., i, a] * B[..., i, b]
            if wA is not None:
                s = s * wA
            cols.append(s)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def _block_mul(C, M):
    """C (..., a, b) @ M (..., b, c) -> (..., a, c) unrolled over the small
    dims; M broadcasts against C's leading dims."""
    a, b = C.shape[-2], C.shape[-1]
    c = M.shape[-1]
    rows = []
    for i in range(a):
        cols = []
        for j in range(c):
            s = C[..., i, 0] * M[..., 0, j]
            for k in range(1, b):
                s = s + C[..., i, k] * M[..., k, j]
            cols.append(s)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def _block_diag(blocks):
    """(K, 6, 6) -> the (K, 6, K, 6) block-diagonal tensor."""
    K, a, b = blocks.shape
    out = torch.zeros((K, K, a, b), dtype=blocks.dtype, device=blocks.device)
    i = torch.arange(K, device=blocks.device)
    out[i, i] = blocks
    return out.permute(0, 2, 1, 3)


def _grid_step(prob: GridBAProblem, R, t, X, lam, cam_model, cam_params,
               chi2_th, use_robust, stereo_bf):
    """One LM step: returns (dx_cam (K,6), dx_pt (P,3), current cost)."""
    P, K = prob.uv.shape[0], prob.R.shape[0]
    dev = X.device
    e, Jc, Jp = _grid_jacobians(prob, R, t, X, cam_model, cam_params, stereo_bf)
    w, chi2, msk = _weights(prob, e, chi2_th, use_robust)
    free = (~prob.cam_fixed).to(torch.float32)
    Jc = Jc * free[None, :, None, None]
    r = e.shape[-1]
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)

    # camera system: one batched matmul over K, with e appended as an extra
    # column so that Hcc and bc come out of the same contraction
    wJc = Jc * w[..., None, None]
    Je = torch.cat([Jc, e[..., None]], dim=-1)                  # (P,K,r,7)
    lhs = wJc.permute(1, 3, 0, 2).reshape(K, 6, P * r)
    rhsm = Je.permute(1, 0, 2, 3).reshape(K, P * r, 7)
    Hb = torch.bmm(lhs, rhsm)                                   # (K, 6, 7)
    Hcc = Hb[:, :, :6]
    bc = -Hb[:, :, 6]

    # point system: plane reductions over (k, i)
    wJp = Jp * w[..., None, None]
    Hpp = torch.sum(_plane_outer(wJp, Jp), dim=1)              # (P, 3, 3)
    bp = -torch.sum(torch.stack(
        [torch.sum(wJp[..., a] * e, dim=-1) for a in range(3)], dim=-1), dim=1)

    # coupling grid: C[p,k] = Jc^T W Jp (6,3)
    C = _plane_outer(wJc, Jp)                                   # (P, K, 6, 3)

    cost = torch.sum((_huber_cost(chi2, chi2_th ** 0.5) if use_robust else chi2) * msk)

    # Schur: S = Hcc_d - U U^T with U = C @ chol(Hpp_d^-1)
    Hcc_d = Hcc + lam * eye6[None]
    Hpp_d = Hpp + lam * eye3[None]
    pt_on = prob.pt_valid.to(torch.float32)[:, None, None]
    Hpp_d = Hpp_d * pt_on + eye3[None] * (1 - pt_on)
    Hpp_inv = _spd_inv3(Hpp_d)
    L = _chol3(Hpp_inv)
    U = _block_mul(C, L[:, None])                               # (P, K, 6, 3)
    Ur = U.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
    S_off = (Ur @ Ur.T).reshape(K, 6, K, 6)

    CW = _block_mul(C, Hpp_inv[:, None])                        # (P, K, 6, 3)
    rv = torch.sum(CW * bp[:, None, None, :], dim=-1)           # (P, K, 6)
    rhs = (bc - torch.sum(rv, dim=0)) * free[:, None]

    S = _block_diag(Hcc_d) - S_off
    S = S * (free[:, None, None, None] * free[None, None, :, None])
    S = S + _block_diag(eye6[None] * (1 - free)[:, None, None])
    dx_cam = smallsolve.solve_psd_blocked(
        S.reshape(K * 6, K * 6), rhs.reshape(K * 6), bs=6).reshape(K, 6)
    dx_cam = dx_cam * free[:, None]

    # back-substitute: dx_p = Hpp_inv (bp - C^T dx_cam)
    s = torch.einsum("pkab,ka->pb", C, dx_cam)
    dx_pt = torch.stack(
        [torch.sum(Hpp_inv[:, b, :] * (bp - s), dim=-1) for b in range(3)], dim=-1)
    dx_pt = dx_pt * prob.pt_valid.to(torch.float32)[:, None]
    return dx_cam, dx_pt, cost


def bundle_adjust_grid(prob: GridBAProblem, cam_model: str, cam_params,
                       iterations: int = 10, lam0: float = 1e-5,
                       chi2_th: float = robust.CHI2_MONO,
                       use_robust: bool = True,
                       stereo_bf: float = 0.0):
    """LM loop with branch-free accept/reject over the grid problem.
    Returns (R, t, X, cost)."""
    dev = prob.X.device
    R, t, X = prob.R, prob.t, prob.X
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    cost = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    for _ in range(iterations):
        dx_cam, dx_pt, cur_cost = _grid_step(
            prob, R, t, X, lam, cam_model, cam_params, chi2_th, use_robust,
            stereo_bf)
        dR, dt = lie.se3_exp(dx_cam)
        R_new, t_new = lie.se3_compose(dR, dt, R, t)
        R_new = lie.normalize_rotation(R_new)
        X_new = X + dx_pt
        new_cost = _grid_cost(prob, R_new, t_new, X_new, cam_model,
                              cam_params, chi2_th, use_robust, stereo_bf)
        accept = new_cost < cur_cost
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.minimum(new_cost, cur_cost)
    return R, t, X, cost
