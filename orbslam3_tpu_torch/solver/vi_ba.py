"""Visual-inertial bundle adjustment: 15-dof body states (pose, velocity,
bias) and marginalized points.

Counterpart of `orbslam3_tpu/solver/vi_ba.py` (reference src/Optimizer.cc):
  * FullInertialBA (:371-762): every keyframe with pose, velocity and bias,
    EdgeInertial between consecutive keyframes, the gyro / acc bias random
    walk edges (information from the covariance blocks 9-11 / 12-14), an
    optional bias prior, monocular reprojection edges under Huber
    sqrt(5.991);
  * LocalInertialBA (:2448-2881): the same residuals over a temporal window,
    the boundary fixed through `cam_fixed`.

Reprojection Jacobians are analytic; the inertial ones come from
`torch.func.jacfwd` around a zero local update (right-multiplicative on the
rotation, additive elsewhere), one factor per `vmap` lane.  The reduced
15K x 15K camera system is solved by PCG with the exact block-Jacobi
preconditioner, either matrix-free (`schur="pcg"`: per-observation
coupling blocks and per-factor pair blocks) or assembled densely
(`schur="dense"`, what the inertial System runs: the visual part as
G G^T from the Cholesky-split coupling, the pair blocks scattered in).

Every scatter that can name one block twice (observations of one camera,
consecutive factors sharing a keyframe) accumulates through
`ba._seg_sum` / `ba._add_blocks` (in a fixed order on a card), as JAX's
`.at[].add` does; a plain `x[idx] += v` would keep one write per index.  The dense reduced system is a float32 product, kept out of TF32 by
the package's precision policy.

Body/camera convention: body pose (Rwb, pwb); the extrinsic Tcb (camera <-
body) is fixed; a world point projects through Xc = Rcb Rwb^T (X - pwb) + tcb.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from ..ops import cameras, lie
from . import robust
from .ba import _add_blocks, _chol3, _pcg, _seg_sum, _spd_inv3
from .inertial import PreintFactor, factor_residual, info_from_cov, jacobian

STATE_DIM = 15  # [dtheta(3), dp(3), dv(3), dbg(3), dba(3)]


class VIProblem(NamedTuple):
    # body states
    Rwb: torch.Tensor        # (K,3,3)
    pwb: torch.Tensor        # (K,3)
    vel: torch.Tensor        # (K,3)
    bias: torch.Tensor       # (K,6)
    cam_fixed: torch.Tensor  # (K,) pose, velocity and bias fixed
    cam_valid: torch.Tensor  # (K,)
    # points
    X: torch.Tensor          # (P,3)
    pt_valid: torch.Tensor
    # reprojection observations
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    obs_uv: torch.Tensor
    obs_inv_sigma2: torch.Tensor
    obs_valid: torch.Tensor
    # inertial factors between keyframes (indices into the K body states)
    factors: PreintFactor
    gravity: torch.Tensor    # (3,) world gravity
    Rcb: torch.Tensor        # (3,3) extrinsics camera <- body
    tcb: torch.Tensor        # (3,)


class VIBAResult(NamedTuple):
    Rwb: torch.Tensor
    pwb: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor
    X: torch.Tensor
    cost: torch.Tensor


def apply_delta(Rwb, pwb, vel, bias, d):
    """Local 15-dof update (right-multiplied rotation, additive rest)."""
    return (Rwb @ lie.exp_so3(d[..., 0:3]), pwb + d[..., 3:6], vel + d[..., 6:9],
            bias + d[..., 9:15])


def project_body(prob: VIProblem, Rwb, pwb, X, cam_model, cam_params):
    Xb = torch.einsum("...ji,...j->...i", Rwb, X - pwb)
    Xc = torch.einsum("ij,...j->...i", prob.Rcb, Xb) + prob.tcb
    return cameras.project(cam_model, cam_params, Xc), Xc


def _obs_mask(prob: VIProblem, Xc):
    ci, pi = prob.obs_cam.long(), prob.obs_pt.long()
    return prob.obs_valid & prob.pt_valid[pi] & prob.cam_valid[ci] & (Xc[..., 2] > 1e-2)


def _reproj_residuals(prob: VIProblem, Rwb, pwb, X, cam_model, cam_params):
    """Residual-only reprojection terms (cost evaluation, no Jacobians)."""
    ci, pi = prob.obs_cam.long(), prob.obs_pt.long()
    uvp, Xc = project_body(prob, Rwb[ci], pwb[ci], X[pi], cam_model, cam_params)
    e = prob.obs_uv - uvp
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2
    return e, chi2, _obs_mask(prob, Xc)


def _reproj_terms(prob: VIProblem, Rwb, pwb, X, cam_model, cam_params, use_robust=True):
    """Per-observation residual and analytic Jacobians wrt the 6-dof pose
    part (right-multiplied rotation, additive position) and the point:
      Xb = Rwb^T (X - pwb);  Xc = Rcb Xb + tcb;  e = uv - proj(Xc)
      dXb/ddtheta = hat(Xb),  dXb/dpwb = -Rwb^T,  dXb/dX = Rwb^T."""
    ci, pi = prob.obs_cam.long(), prob.obs_pt.long()
    Rbw = Rwb[ci].transpose(-1, -2)                               # (O,3,3)
    Xb = torch.einsum("nij,nj->ni", Rbw, X[pi] - pwb[ci])
    Xc = torch.einsum("ij,nj->ni", prob.Rcb, Xb) + prob.tcb
    e = prob.obs_uv - cameras.project(cam_model, cam_params, Xc)
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)       # (O,2,3)
    dXb = torch.cat([lie.hat(Xb), -Rbw], dim=-1)                  # (O,3,6)
    JR = torch.einsum("nij,jk->nik", Jproj, prob.Rcb)
    Jc = -torch.einsum("nij,njk->nik", JR, dXb)                   # (O,2,6)
    Jp = -torch.einsum("nij,njk->nik", JR, Rbw)                   # (O,2,3)
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2
    w_rob = robust.huber_weight(chi2, robust.HUBER_MONO) if use_robust else 1.0
    m = _obs_mask(prob, Xc)
    w = prob.obs_inv_sigma2 * w_rob * m.to(torch.float32)
    free = (~prob.cam_fixed)[ci].to(torch.float32)
    return e, Jc * free[:, None, None], Jp, w, chi2, m


def _ends(prob: VIProblem, Rwb, pwb, vel, bias):
    f = prob.factors
    ki, kj = f.kf_i.long(), f.kf_j.long()
    return (Rwb[ki], pwb[ki], vel[ki], bias[ki]), (Rwb[kj], pwb[kj], vel[kj], bias[kj])


def _edge_weights(prob: VIProblem):
    """(W (F,9,9), w_edge (F,), Wb (F,6,6)): factor information, the mask of
    factors with a free end, and the bias random walk's information."""
    f = prob.factors
    ki, kj = f.kf_i.long(), f.kf_j.long()
    W = info_from_cov(f.C[:, :9, :9])
    w_edge = f.valid.to(torch.float32) * \
        (~prob.cam_fixed[ki] | ~prob.cam_fixed[kj]).to(torch.float32)
    eye6 = torch.eye(6, dtype=f.C.dtype, device=f.C.device)
    Wb = torch.linalg.inv_ex(f.C[:, 9:15, 9:15] + eye6 * 1e-12).inverse
    return W, w_edge, Wb


def _inertial_residuals(prob: VIProblem, Rwb, pwb, vel, bias):
    """Residual-only inertial and bias random walk terms (cost evaluation)."""
    (Ri, pi, vi, bi), (Rj, pj, vj, bj) = _ends(prob, Rwb, pwb, vel, bias)
    r = factor_residual(prob.factors, Ri, pi, vi, Rj, pj, vj, bi, prob.gravity)
    W, w_edge, Wb = _edge_weights(prob)
    return r, W, w_edge, bj - bi, Wb


def _pair_residual(di, dj, fk, Ri, pi, vi, bi, Rj, pj, vj, bj, g):
    R1, p1, v1, b1 = apply_delta(Ri, pi, vi, bi, di)
    R2, p2, v2, _ = apply_delta(Rj, pj, vj, bj, dj)
    return factor_residual(fk, R1, p1, v1, R2, p2, v2, b1, g)


_pair_jacobians = vmap(lambda *a: jacobian(_pair_residual, *a, argnums=(0, 1)),
                       in_dims=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None))


def _inertial_terms(prob: VIProblem, Rwb, pwb, vel, bias):
    """Per-factor 9-dof inertial residual with its Jacobians wrt both
    15-dof states, and the 6-dof bias random walk residual and info."""
    f = prob.factors
    ends = _ends(prob, Rwb, pwb, vel, bias)
    z = torch.zeros(STATE_DIM, dtype=Rwb.dtype, device=Rwb.device)
    zf = z.expand(f.dT.shape[0], STATE_DIM)
    r = _pair_residual(zf, zf, f, *ends[0], *ends[1], prob.gravity)   # (F,9)
    Ji, Jj = _pair_jacobians(z, z, f, *ends[0], *ends[1], prob.gravity)  # (F,9,15)
    W, w_edge, Wb = _edge_weights(prob)
    free = (~prob.cam_fixed).to(torch.float32)
    Ji = Ji * free[f.kf_i.long()][:, None, None]
    Jj = Jj * free[f.kf_j.long()][:, None, None]
    return r, Ji, Jj, W, w_edge, ends[1][3] - ends[0][3], Wb


def _corner(X):
    """(F, 6, 6) bias blocks as (F, 15, 15) blocks at [9:15, 9:15]."""
    return torch.nn.functional.pad(X, (9, 0, 9, 0))


def _robust_cost(chi2, m, rob: bool):
    if rob:
        e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
        cr = torch.where(e <= robust.HUBER_MONO, chi2, 2 * robust.HUBER_MONO * e - robust.CHI2_MONO)
    else:
        cr = chi2
    return torch.sum(cr * m.to(torch.float32))


def _inertial_cost(r_in, W, rb, Wb, w_edge):
    c_in = torch.sum(w_edge * torch.einsum("fa,fab,fb->f", r_in, W, r_in))
    c_rw = torch.sum(w_edge * torch.einsum("fa,fab,fb->f", rb, Wb, rb))
    return c_in + c_rw


def vi_bundle_adjust(prob: VIProblem, cam_model: str, cam_params, iterations: int = 10,
                     lam0: float = 1e-5, use_robust: bool = True, bias_prior: float = 0.0,
                     pcg_iters: int = 24, schur: str = "pcg") -> VIBAResult:
    """Joint LM over body states and points (FullInertialBA semantics).
    `pcg_iters` PCG steps solve the reduced system per LM iteration;
    `schur="dense"` assembles it (memory: the (K, P, 15, 3) split tensor,
    right for windows), `"pcg"` applies it matrix-free."""
    K = prob.Rwb.shape[0]
    P = prob.X.shape[0]
    D = STATE_DIM
    f = prob.factors
    ki, kj = f.kf_i.long(), f.kf_j.long()
    ci, pi = prob.obs_cam.long(), prob.obs_pt.long()
    dev, dt = prob.Rwb.device, prob.Rwb.dtype
    eyeD = torch.eye(D, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    free = (~prob.cam_fixed).to(dt)
    pt_on = prob.pt_valid.to(dt)

    def build_and_solve(Rwb, pwb, vel, bias, X, lam):
        e, Jc6, Jp, w, chi2, m = _reproj_terms(prob, Rwb, pwb, X, cam_model, cam_params,
                                               use_robust)
        O = e.shape[0]
        Jc = torch.cat([Jc6, torch.zeros((O, 2, D - 6), dtype=dt, device=dev)], dim=-1)
        wJc = Jc * w[:, None, None]
        Hcc = _seg_sum(K, ci, torch.einsum("nik,nil->nkl", wJc, Jc))
        bc = _seg_sum(K, ci, -torch.einsum("nik,ni->nk", wJc, e))
        wJp = Jp * w[:, None, None]
        Hpp = _seg_sum(P, pi, torch.einsum("nik,nil->nkl", wJp, Jp))
        bp = _seg_sum(P, pi, -torch.einsum("nik,ni->nk", wJp, e))
        Cobs = torch.einsum("nik,nil->nkl", wJc, Jp)                   # (O,15,3)

        r_in, Ji, Jj, W, w_edge, rb, Wb = _inertial_terms(prob, Rwb, pwb, vel, bias)
        Wr = torch.einsum("fab,fb->fa", W, r_in)
        we1 = w_edge[:, None]
        bc = bc.index_add(0, ki, -we1 * torch.einsum("fak,fa->fk", Ji, Wr))
        bc = bc.index_add(0, kj, -we1 * torch.einsum("fak,fa->fk", Jj, Wr))
        # bias random walk: d rb / d bias_i = -I, d rb / d bias_j = +I
        Wrb = torch.einsum("fab,fb->fa", Wb, rb)
        pad = lambda v: torch.nn.functional.pad(v, (9, 0))
        bc = bc.index_add(0, ki, pad(we1 * Wrb))
        bc = bc.index_add(0, kj, pad(-we1 * Wrb))
        if bias_prior > 0:
            Hcc = Hcc + torch.block_diag(torch.zeros(9, 9, dtype=dt, device=dev),
                                         torch.eye(6, dtype=dt, device=dev))[None] * bias_prior
            bc = bc - bias_prior * pad(bias)

        gi = free[ki] * w_edge
        gj = free[kj] * w_edge
        Hcc_d = Hcc + lam * eyeD[None]
        Hpp_d = Hpp + lam * eye3[None]
        po = pt_on[:, None, None]
        Hpp_d = Hpp_d * po + eye3[None] * (1 - po)
        Hpp_inv = _spd_inv3(Hpp_d)
        CW = torch.einsum("nij,njl->nil", Cobs, Hpp_inv[pi])
        cur = _robust_cost(chi2, m, use_robust) + _inertial_cost(r_in, W, rb, Wb, w_edge)
        WJi = torch.einsum("fab,fbk->fak", W, Ji)
        WJj = torch.einsum("fab,fbk->fak", W, Jj)
        we = w_edge[:, None, None]
        # rhs = bc - C Hpp^-1 bp
        rv = torch.einsum("nil,nl->ni", CW, bp[pi])
        rhs = (bc - _seg_sum(K, ci, rv)) * free[:, None]

        if schur == "dense":
            L = _chol3(Hpp_inv)
            U = torch.einsum("nij,njl->nil", Cobs, L[pi])
            G = _seg_sum(K * P, ci * P + pi, U).reshape(K, P, D, 3)
            Gr = G.permute(0, 2, 1, 3).reshape(K * D, P * 3)
            S = -(Gr @ Gr.T).reshape(K, D, K, D)
            ar = torch.arange(K, device=dev)
            _add_blocks(S, ar, ar, Hcc_d)
            # inertial pair blocks (Gauss-Newton of the whitened edge)
            _add_blocks(S, ki, ki, we * torch.einsum("fak,fal->fkl", Ji, WJi))
            _add_blocks(S, kj, kj, we * torch.einsum("fak,fal->fkl", Jj, WJj))
            _add_blocks(S, ki, kj, we * torch.einsum("fak,fal->fkl", Ji, WJj))
            _add_blocks(S, kj, ki, we * torch.einsum("fak,fal->fkl", Jj, WJi))
            # bias random-walk blocks on dims 9:15
            bb = we * Wb
            _add_blocks(S, ki, ki, bb * (gi * gi)[:, None, None], lo=9)
            _add_blocks(S, kj, kj, bb * (gj * gj)[:, None, None], lo=9)
            _add_blocks(S, ki, kj, -bb * (gi * gj)[:, None, None], lo=9)
            _add_blocks(S, kj, ki, -bb * (gi * gj)[:, None, None], lo=9)
            # fixed cameras: identity rows and columns
            S = S * (free[:, None, None, None] * free[None, None, :, None])
            _add_blocks(S, ar, ar, eyeD[None] * (1 - free)[:, None, None])
            Dg = S[ar, :, ar, :] + eyeD[None] * 1e-8
            D_inv = torch.linalg.inv_ex(Dg).inverse
            Sm = S.reshape(K * D, K * D)

            def matvec(x):
                y = (Sm @ x.reshape(-1)).reshape(K, D)
                return y * free[:, None] + x * (1 - free)[:, None]
        else:
            Dm = Hcc_d - _seg_sum(K, ci, torch.einsum("nil,nml->nim", CW, Cobs))
            Dm = Dm.index_add(0, ki, we * torch.einsum("fak,fal->fkl", Ji, WJi))
            Dm = Dm.index_add(0, kj, we * torch.einsum("fak,fal->fkl", Jj, WJj))
            Dm = Dm.index_add(0, ki, _corner(we * Wb * gi[:, None, None]))
            Dm = Dm.index_add(0, kj, _corner(we * Wb * gj[:, None, None]))
            Dm = Dm * free[:, None, None] + eyeD[None] * (1 - free)[:, None, None]
            Dm = Dm + eyeD[None] * 1e-8
            D_inv = torch.linalg.inv_ex(Dm).inverse

            def matvec(x):
                xm = x * free[:, None]
                y = torch.einsum("kij,kj->ki", Hcc_d, xm)
                # visual Schur term
                u = torch.einsum("nij,ni->nj", Cobs, xm[ci])
                s = _seg_sum(P, pi, u)
                v = torch.einsum("nil,nl->ni", CW, s[pi])
                y = y - _seg_sum(K, ci, v)
                # inertial pair blocks
                ai = torch.einsum("fak,fk->fa", Ji, xm[ki])
                aj = torch.einsum("fak,fk->fa", Jj, xm[kj])
                tw = torch.einsum("fab,fb->fa", W, ai + aj) * w_edge[:, None]
                y = y.index_add(0, ki, torch.einsum("fak,fa->fk", Ji, tw))
                y = y.index_add(0, kj, torch.einsum("fak,fa->fk", Jj, tw))
                # bias random walk pair blocks
                db = xm[kj, 9:15] * gj[:, None] - xm[ki, 9:15] * gi[:, None]
                tb = torch.einsum("fab,fb->fa", Wb, db) * w_edge[:, None]
                y = y.index_add(0, ki, pad(-tb * gi[:, None]))
                y = y.index_add(0, kj, pad(tb * gj[:, None]))
                return y * free[:, None] + x * (1 - free)[:, None]

        dx_cam = _pcg(matvec, lambda r: torch.einsum("kij,kj->ki", D_inv, r), rhs, pcg_iters)
        dx_cam = dx_cam * free[:, None]
        u = torch.einsum("nij,ni->nj", Cobs, dx_cam[ci])
        dx_pt = torch.einsum("pij,pj->pi", Hpp_inv, bp - _seg_sum(P, pi, u))
        return dx_cam, dx_pt * pt_on[:, None], cur

    def total_cost(Rwb, pwb, vel, bias, X):
        """Residuals-only cost (the accept/reject test)."""
        _, chi2, m = _reproj_residuals(prob, Rwb, pwb, X, cam_model, cam_params)
        r_in, W, w_edge, rb, Wb = _inertial_residuals(prob, Rwb, pwb, vel, bias)
        return _robust_cost(chi2, m, use_robust) + _inertial_cost(r_in, W, rb, Wb, w_edge)

    Rwb, pwb, vel, bias, X = prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.X
    lam = torch.full((), lam0, dtype=dt, device=dev)
    cost = torch.full((), float("inf"), dtype=dt, device=dev)
    for _ in range(iterations):
        dx_cam, dx_pt, cur = build_and_solve(Rwb, pwb, vel, bias, X, lam)
        R2, p2, v2, b2 = apply_delta(Rwb, pwb, vel, bias, dx_cam)
        R2 = lie.normalize_rotation(R2)
        X2 = X + dx_pt
        new = total_cost(R2, p2, v2, b2, X2)
        ok = new < cur
        Rwb = torch.where(ok, R2, Rwb)
        pwb = torch.where(ok, p2, pwb)
        vel = torch.where(ok, v2, vel)
        bias = torch.where(ok, b2, bias)
        X = torch.where(ok, X2, X)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-9, 1e9)
        cost = torch.minimum(new, cur)
    return VIBAResult(Rwb=Rwb, pwb=pwb, vel=vel, bias=bias, X=X, cost=cost)
