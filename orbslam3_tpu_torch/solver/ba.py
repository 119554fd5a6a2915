"""Visual bundle adjustment over a COO observation list: batched
Levenberg-Marquardt with the Schur complement on the camera-point system.

Counterpart of `orbslam3_tpu/solver/ba.py` (parity targets, reference
src/Optimizer.cc: BundleAdjustment / GlobalBundleAdjustemnt :60-369 and
LocalBundleAdjustment :1069-1360; marginalized points, Huber sqrt(5.991)
for mono).  Per LM step:
  1. residuals and analytic Jacobians of every observation in one batch;
  2. the point blocks H_pp (3x3) inverted in closed form;
  3. the reduced camera system S = H_cc - C H_pp^-1 C^T, either applied
     matrix-free (`_solve_schur`: per-observation (6, 3) coupling blocks,
     gathers and segment sums) and solved by PCG with the exact
     block-Jacobi preconditioner, or assembled (`_solve_schur_dense`: the
     coupling split by the Cholesky factor of H_pp^-1, S = H_cc - G G^T as
     one product) and solved by the unrolled block Cholesky;
  4. the points back-substituted; the step accepted on the device when it
     lowers the cost (`torch.where` on the carried state).
Fixed cameras carry zeroed Jacobians and identity blocks.

Every scatter that can name one block twice (observations of one camera or
of one point) accumulates with `index_add_` on flattened indices, as JAX's
`.at[].add` does; `x[idx] += v` would keep one write per index.  Dense
inverses use `inv_ex`, which reads no status back.  `mapping.run_local_ba`
gathers the problems; the grid solver (`solver/ba_grid.py`) and the
visual-inertial BA (`solver/vi_ba.py`) share the closed-form 3x3 blocks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import cameras, lie, smallsolve
from . import robust


class BAProblem(NamedTuple):
    """Fixed-capacity visual BA problem with COO observations.  Stereo
    observations carry obs_ur >= 0 (the rectified right-image u): with a
    nonzero `stereo_bf` (fx * baseline) they add the reference's third
    residual row ur - (u_proj - bf / z).  The optional per-camera position
    priors are the GNSS-constrained BA's."""
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


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    obs_chi2: torch.Tensor   # (O,) final chi2 per observation
    cost: torch.Tensor       # robust total cost


def _seg_sum(n: int, idx, vals):
    """zeros(n, ...).at[idx].add(vals)."""
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx.long(), vals)


def _add_blocks(S, ki, kj, X, lo: int = 0):
    """S.at[ki, lo:lo+d, kj, lo:lo+d].add(X) on S (K, D, K, D), X (F, d, d);
    the rows of repeated (ki, kj) pairs accumulate."""
    K, D = S.shape[0], S.shape[1]
    d = X.shape[-1]
    a = torch.arange(lo, lo + d, device=S.device)
    row = ki.long()[:, None] * D + a[None, :]                  # (F, d)
    col = kj.long()[:, None] * D + a[None, :]
    flat = row[:, :, None] * (K * D) + col[:, None, :]         # (F, d, d)
    S.view(-1).index_add_(0, flat.reshape(-1), X.reshape(-1))
    return S


def _pcg(matvec, precond, rhs, iters: int):
    """Preconditioned CG from 0 for a fixed number of steps, with the JAX
    package's guarded divisions (branch-free; inexact LM is safe)."""
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    for _ in range(iters):
        Ap = matvec(p)
        rz = torch.sum(r * z)
        den = torch.sum(p * Ap)
        al = rz / torch.where(torch.abs(den) < 1e-20, 1e-20, den)
        x = x + al * p
        r = r - al * Ap
        z = precond(r)
        be = torch.sum(r * z) / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + be * p
    return x


def _residuals(prob: BAProblem, R, t, X, cam_model, cam_params, stereo_bf: float = 0.0):
    ci, pi = prob.obs_cam.long(), prob.obs_pt.long()
    Xc = lie.se3_apply(R[ci], t[ci], X[pi])
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.obs_uv - uvp
    if stereo_bf > 0.0 and prob.obs_ur is not None:
        ur_pred = uvp[:, 0] - stereo_bf / torch.clamp_min(Xc[:, 2], 1e-6)
        e3 = torch.where(prob.obs_ur >= 0, prob.obs_ur - ur_pred, 0.0)
        e = torch.cat([e, e3[:, None]], dim=1)
    return e, Xc


def _jacobians(prob: BAProblem, R, t, X, cam_model, cam_params, stereo_bf: float = 0.0):
    """Per-observation residual and Jacobians wrt the camera (left-multiplied
    se3, translation first) and the point (world).  Returns e (O, r), Jc
    (O, r, 6), Jp (O, r, 3), Xc with r = 2 (mono) or 3 (stereo row)."""
    ci, pi = prob.obs_cam.long(), prob.obs_pt.long()
    Rc = R[ci]
    Xc = lie.se3_apply(Rc, t[ci], X[pi])
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.obs_uv - uvp
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)       # (O, 2, 3)
    O = ci.shape[0]
    if stereo_bf > 0.0 and prob.obs_ur is not None:
        z = torch.clamp_min(Xc[:, 2], 1e-6)
        has_d = prob.obs_ur >= 0
        e3 = torch.where(has_d, prob.obs_ur - (uvp[:, 0] - stereo_bf / z), 0.0)
        e = torch.cat([e, e3[:, None]], dim=1)
        # d ur_pred / dXc = d u / dXc + bf / z^2 * d z / dXc
        dz = torch.zeros((O, 3), dtype=Xc.dtype, device=Xc.device)
        dz[:, 2] = 1.0
        Jur = (Jproj[:, 0, :] + (stereo_bf / (z * z))[:, None] * dz) * \
            has_d[:, None].to(Xc.dtype)
        Jproj = torch.cat([Jproj, Jur[:, None, :]], dim=1)       # (O, 3, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(O, 3, 3)
    dXc_dcam = torch.cat([eye, -lie.hat(Xc)], dim=-1)
    Jc = -torch.einsum("nij,njk->nik", Jproj, dXc_dcam)
    Jp = -torch.einsum("nij,njk->nik", Jproj, Rc)
    return e, Jc, Jp, Xc


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


def _huber_cost(chi2, delta: float):
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= delta, chi2, 2 * delta * e - delta * delta)


def _obs_mask(prob: BAProblem):
    return prob.obs_valid & prob.pt_valid[prob.obs_pt.long()] & \
        prob.cam_valid[prob.obs_cam.long()]


def _prior_terms(prob: BAProblem, R, t):
    """(weights (K,), camera centre - prior (K, 3)) of the position priors."""
    w_pr = prob.prior_w * (~prob.cam_fixed).to(R.dtype) * prob.cam_valid.to(R.dtype)
    Ow = -torch.einsum("kji,kj->ki", R, t)
    return w_pr, Ow - prob.prior_pos


def _build_normal_eq(prob: BAProblem, R, t, X, cam_model, cam_params, chi2_th: float,
                     use_robust: bool, stereo_bf: float = 0.0):
    """Weighted residuals and Jacobians and the Schur pieces: (Hcc (K,6,6),
    bc (K,6), Hpp (P,3,3), bp (P,3), Cobs (O,6,3), cost, chi2, mask)."""
    e, Jc, Jp, _ = _jacobians(prob, R, t, X, cam_model, cam_params, stereo_bf)
    ci, pi = prob.obs_cam.long(), prob.obs_pt.long()
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2
    delta = chi2_th ** 0.5
    w_rob = robust.huber_weight(chi2, delta) if use_robust else 1.0
    m = _obs_mask(prob)
    w = prob.obs_inv_sigma2 * w_rob * m.to(e.dtype)
    Jc = Jc * (~prob.cam_fixed)[ci].to(e.dtype)[:, None, None]
    K, P = prob.R.shape[0], prob.X.shape[0]
    wJc = Jc * w[:, None, None]
    Hcc = _seg_sum(K, ci, torch.einsum("nik,nil->nkl", wJc, Jc))
    bc = _seg_sum(K, ci, -torch.einsum("nik,ni->nk", wJc, e))
    if prob.prior_pos is not None and prob.prior_w is not None:
        # camera-centre prior r = O_k - prior; O = -R^T t, dO/d(dt) = -R^T
        # under the left-multiplied update, dO/d(dtheta) = 0 to first order
        w_pr, r_pr = _prior_terms(prob, R, t)
        eye3 = torch.eye(3, dtype=e.dtype, device=e.device)
        Hcc = Hcc + torch.nn.functional.pad(w_pr[:, None, None] * eye3, (3, 0, 3, 0))
        bc = bc + torch.nn.functional.pad(
            w_pr[:, None] * torch.einsum("kij,kj->ki", R, r_pr), (3, 0))
    wJp = Jp * w[:, None, None]
    Hpp = _seg_sum(P, pi, torch.einsum("nik,nil->nkl", wJp, Jp))
    bp = _seg_sum(P, pi, -torch.einsum("nik,ni->nk", wJp, e))
    # the camera-point coupling kept per observation: Cobs[n] = Jc^T W Jp
    Cobs = torch.einsum("nik,nil->nkl", wJc, Jp)
    cost = torch.sum((_huber_cost(chi2, delta) if use_robust else chi2) * m.to(e.dtype))
    return Hcc, bc, Hpp, bp, Cobs, cost, chi2, m


def _cost_only(prob: BAProblem, R, t, X, cam_model, cam_params, chi2_th: float,
               use_robust: bool, stereo_bf: float = 0.0):
    e, _ = _residuals(prob, R, t, X, cam_model, cam_params, stereo_bf)
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2
    c = _huber_cost(chi2, chi2_th ** 0.5) if use_robust else chi2
    total = torch.sum(c * _obs_mask(prob).to(e.dtype))
    if prob.prior_pos is not None and prob.prior_w is not None:
        w_pr, r_pr = _prior_terms(prob, R, t)
        total = total + torch.sum(w_pr * torch.sum(r_pr ** 2, dim=-1))
    return total


def _damped_points(Hpp, lam, pt_valid):
    """H_pp + lam I with empty points' blocks the identity, and its inverse."""
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    pt_on = pt_valid.to(Hpp.dtype)[:, None, None]
    Hpp_d = (Hpp + lam * eye3) * pt_on + eye3 * (1 - pt_on)
    return _spd_inv3(Hpp_d)


def _back_substitute(Cobs, dx_cam, Hpp_inv, bp, ci, pi, pt_valid):
    """dx_p = Hpp^-1 (bp - C^T dx_cam) on the valid points."""
    u = torch.einsum("nij,ni->nj", Cobs, dx_cam[ci])
    dx_pt = torch.einsum("pij,pj->pi", Hpp_inv, bp - _seg_sum(Hpp_inv.shape[0], pi, u))
    return dx_pt * pt_valid.to(dx_pt.dtype)[:, None]


def _solve_schur(Hcc, bc, Hpp, bp, Cobs, obs_cam, obs_pt, lam, cam_fixed, pt_valid,
                 pcg_iters: int = 32):
    """One LM step, matrix-free: (dx_cam (K, 6), dx_pt (P, 3)).  S x is
    applied through the per-observation coupling blocks; PCG with the exact
    block-Jacobi preconditioner (S's diagonal blocks, one segment sum)."""
    K, P = Hcc.shape[0], Hpp.shape[0]
    ci, pi = obs_cam.long(), obs_pt.long()
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Hcc_d = Hcc + lam * eye6
    Hpp_inv = _damped_points(Hpp, lam, pt_valid)
    free = (~cam_fixed).to(Hcc.dtype)
    CW = torch.einsum("nij,njl->nil", Cobs, Hpp_inv[pi])          # (O, 6, 3)

    def matvec(x):
        """Hcc_d x - C Hpp^-1 C^T x, fixed cameras the identity."""
        xm = x * free[:, None]
        u = torch.einsum("nij,ni->nj", Cobs, xm[ci])
        v = torch.einsum("nil,nl->ni", CW, _seg_sum(P, pi, u)[pi])
        y = torch.einsum("kij,kj->ki", Hcc_d, xm) - _seg_sum(K, ci, v)
        return y * free[:, None] + x * (1 - free)[:, None]

    rv = torch.einsum("nil,nl->ni", CW, bp[pi])
    rhs = (bc - _seg_sum(K, ci, rv)) * free[:, None]
    Dm = Hcc_d - _seg_sum(K, ci, torch.einsum("nil,nml->nim", CW, Cobs))
    Dm = Dm * free[:, None, None] + eye6 * (1 - free)[:, None, None] + eye6 * 1e-8
    D_inv = torch.linalg.inv_ex(Dm).inverse
    dx_cam = _pcg(matvec, lambda r: torch.einsum("kij,kj->ki", D_inv, r), rhs, pcg_iters)
    dx_cam = dx_cam * free[:, None]
    return dx_cam, _back_substitute(Cobs, dx_cam, Hpp_inv, bp, ci, pi, pt_valid)


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


def _solve_schur_dense(Hcc, bc, Hpp, bp, Cobs, obs_cam, obs_pt, lam, cam_fixed, pt_valid):
    """One LM step through the assembled (6K, 6K) Schur complement (window
    sizes): with L_p = chol(Hpp_inv_p) the scatter G[cam_n, pt_n] +=
    Cobs_n L_{pt_n} gives C Hpp^-1 C^T = G G^T as one product; the system
    is solved by the unrolled block Cholesky."""
    K, P = Hcc.shape[0], Hpp.shape[0]
    ci, pi = obs_cam.long(), obs_pt.long()
    dev, dt = Hcc.device, Hcc.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * eye6
    Hpp_inv = _damped_points(Hpp, lam, pt_valid)
    free = (~cam_fixed).to(dt)
    U = torch.einsum("nij,njl->nil", Cobs, _chol3(Hpp_inv)[pi])
    Gr = _seg_sum(K * P, ci * P + pi, U).reshape(K, P, 6, 3).permute(0, 2, 1, 3).reshape(
        K * 6, P * 3)
    CW = torch.einsum("nij,njl->nil", Cobs, Hpp_inv[pi])
    rv = torch.einsum("nil,nl->ni", CW, bp[pi])
    rhs = (bc - _seg_sum(K, ci, rv)) * free[:, None]
    ar = torch.arange(K, device=dev)
    S = _add_blocks(-(Gr @ Gr.T).reshape(K, 6, K, 6), ar, ar, Hcc_d)
    # fixed cameras: identity rows and columns, zero rhs
    S = _add_blocks(S * (free[:, None, None, None] * free[None, None, :, None]), ar, ar,
                    eye6 * (1 - free)[:, None, None])
    dx_cam = smallsolve.solve_psd_blocked(S.reshape(K * 6, K * 6), rhs.reshape(K * 6),
                                          bs=6).reshape(K, 6)
    dx_cam = dx_cam * free[:, None]
    return dx_cam, _back_substitute(Cobs, dx_cam, Hpp_inv, bp, ci, pi, pt_valid)


def bundle_adjust(prob: BAProblem, cam_model: str, cam_params, iterations: int = 10,
                  lam0: float = 1e-5, chi2_th: float = robust.CHI2_MONO,
                  use_robust: bool = True, stereo_bf: float = 0.0, pcg_iters: int = 32,
                  schur_solver: str = "pcg") -> BAResult:
    """LM with the accept/reject on the device (reference g2o LM; iteration
    counts per call site: 20 init GBA, 10 local, 25 inertial)."""
    R, t, X = prob.R, prob.t, prob.X
    dev, dt = R.device, R.dtype
    lam = torch.full((), lam0, dtype=dt, device=dev)
    cost = torch.full((), float("inf"), dtype=dt, device=dev)
    for _ in range(iterations):
        Hcc, bc, Hpp, bp, Cobs, cur, _, _ = _build_normal_eq(
            prob, R, t, X, cam_model, cam_params, chi2_th, use_robust, stereo_bf)
        if schur_solver == "dense":
            dx_cam, dx_pt = _solve_schur_dense(Hcc, bc, Hpp, bp, Cobs, prob.obs_cam,
                                               prob.obs_pt, lam, prob.cam_fixed, prob.pt_valid)
        else:
            dx_cam, dx_pt = _solve_schur(Hcc, bc, Hpp, bp, Cobs, prob.obs_cam, prob.obs_pt,
                                         lam, prob.cam_fixed, prob.pt_valid,
                                         pcg_iters=pcg_iters)
        dR, dtr = lie.se3_exp(dx_cam)
        R2, t2 = lie.se3_compose(dR, dtr, R, t)
        R2 = lie.normalize_rotation(R2)
        X2 = X + dx_pt
        new = _cost_only(prob, R2, t2, X2, cam_model, cam_params, chi2_th, use_robust,
                         stereo_bf)
        ok = new < cur
        R = torch.where(ok, R2, R)
        t = torch.where(ok, t2, t)
        X = torch.where(ok, X2, X)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.minimum(new, cur)
    e, _ = _residuals(prob, R, t, X, cam_model, cam_params)
    return BAResult(R=R, t=t, X=X, obs_chi2=torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2,
                    cost=cost)
