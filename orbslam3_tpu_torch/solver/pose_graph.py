"""Sim(3) pose-graph optimization (the essential graph of loop closing).

Counterpart of `orbslam3_tpu/solver/pose_graph.py` (parity target:
reference Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:1848-2179):
7-dof Sim3 vertices S_iw (world -> keyframe), edges with relative Sim3
measurements from the spanning tree, strong covisibility links and loop
closures, identity information.  The residual of an edge is the
component-wise chart r = [Log(R_err), t_err, log(s_err)] of
E = S_m^-1 S_i S_j^-1, zero when the relative pose matches; LM over the
stacked local deltas [dphi (right-multiplied), dt, dsigma].

Each edge's 7x14 Jacobian wrt its two vertex deltas comes from
`torch.func.jacfwd` at zero, one edge per `vmap` lane (the JAX package's
`_edge_blocks`).  `solver="dense"` (below 512 vertices) scatters the blocks
into the (7K, 7K) normal matrix, which equals JAX's J^T J of the
graph-wide `jax.jacfwd` (K = 256: 5,607 x 1,792 in float32, which the
blocks never materialize), and solves it with `linalg.solve_ex`;
`solver="cg"` applies it matrix-free with a block-Jacobi preconditioner.
Every block scatter accumulates through `ba._seg_sum` / `ba._add_blocks`
(T14: edges share vertices; in a fixed order on a card); no solve reads a
status back.  The Jacobians at zero rotation
go through `lie.log_so3`'s guarded form (T9).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..ops import lie
from ..slam_map.state import _upload
from .ba import _add_blocks, _seg_sum
from .inertial import jacobian

# 4-DoF inertial mode: yaw (world-z right perturbation) + translation;
# roll, pitch and scale locked (reference VertexPose4DoF / Edge4DoF)
DOF4_MASK = (0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0)


class PoseGraphResult(NamedTuple):
    R: torch.Tensor     # (K, 3, 3) S_iw rotation
    t: torch.Tensor     # (K, 3)
    s: torch.Tensor     # (K,)
    cost: torch.Tensor


def _sim3_apply_delta(R, t, s, d):
    """7-dof local update d = [dphi (3), dt (3), dsigma (1)]; s (..., 1)."""
    return R @ lie.exp_so3(d[..., 0:3]), t + d[..., 3:6], s * torch.exp(d[..., 6:7])


def _inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv * lie._mv(Rt, t), s_inv


def _compose(Ra, ta, sa, Rb, tb, sb):
    return Ra @ Rb, sa * lie._mv(Ra, tb) + ta, sa * sb


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r of E = S_m^-1 (S_i S_j^-1), with S x = s R x + t; (..., 7).  The
    scales carry a trailing dimension of 1 (`lie.sim3_*` take them without):
    under `torch.func.jacfwd`, torch 2.13 gives a 0-d float32 tensor combined
    with a Python float a float64 tangent, as `lie.log_so3` notes."""
    Rij, tij, sij = _compose(Ri, ti, si, *_inverse(Rj, tj, sj))
    Re, te, se = _compose(*_inverse(Rm, tm, sm), Rij, tij, sij)
    return torch.cat([lie.log_so3(Re), te, torch.log(torch.clamp_min(se, 1e-9))], dim=-1)


def _res_k(d, Ri, ti, si, Rj, tj, sj, fi, fj, Rm, tm, sm, w, ok):
    """One edge's weighted residual at the local deltas d = [d_i, d_j] (14,),
    the frozen components masked by fi / fj; 0 for an invalid edge.  The
    scales and w, ok carry a trailing dimension of 1."""
    r = _edge_residual(*_sim3_apply_delta(Ri, ti, si, d[..., 0:7] * fi),
                       *_sim3_apply_delta(Rj, tj, sj, d[..., 7:14] * fj), Rm, tm, sm) * w
    return torch.where(ok, r, torch.zeros_like(r))


_edge_jacobians = vmap(lambda *a: jacobian(_res_k, *a), in_dims=(None,) + (0,) * 13)


def optimize_pose_graph(R, t, s, fixed, valid, e_i, e_j, e_R, e_t, e_s, e_valid,
                        e_weight=None, iterations: int = 20, lam0: float = 1e-4,
                        dof_mask=None, solver: str = "auto",
                        cg_iters: int = 48) -> PoseGraphResult:
    """R/t/s: (K, ...) Sim3 vertices S_iw; fixed/valid: (K,) masks; e_*: (E, ...)
    edges with measurements S_ij = S_i S_j^-1; e_weight: optional (E,)
    sqrt-information scalars; dof_mask: optional (7,) per-component delta
    mask.  The rotation delta is a right (world-frame) perturbation, so on a
    gravity-aligned map DOF4_MASK gives the reference's 4-DoF inertial
    essential graph (yaw + translation; Optimizer::OptimizeEssentialGraph4DoF).
    `solver`: "dense", "cg" or "auto" (dense below 512 vertices)."""
    K = R.shape[0]
    E = e_i.shape[0]
    dev, dt = R.device, R.dtype
    free = (~fixed) & valid
    if e_weight is None:
        e_weight = torch.ones(E, dtype=dt, device=dev)
    if dof_mask is None:
        dof_mask = torch.ones(7, dtype=dt, device=dev)
    elif not isinstance(dof_mask, torch.Tensor):
        dof_mask = _upload(np.asarray(dof_mask, np.float32), dev)
    # per-component free mask (K, 7): vertex gating x DoF gating
    free_c = free[:, None].to(dt) * dof_mask.to(dt)[None, :]
    diag_pin = 1.0 - free_c
    if solver == "auto":
        solver = "dense" if K < 512 else "cg"
    ii = torch.clamp_min(e_i, 0).long()
    jj = torch.clamp_min(e_j, 0).long()
    eye7 = torch.eye(7, dtype=dt, device=dev)
    z14 = torch.zeros(14, dtype=dt, device=dev)

    def edge_args(Rc, tc, sc):
        return (Rc[ii], tc[ii], sc[ii, None], Rc[jj], tc[jj], sc[jj, None], free_c[ii],
                free_c[jj], e_R, e_t, e_s[:, None], e_weight[:, None], e_valid[:, None])

    def residuals(Rc, tc, sc):
        return _res_k(z14, *edge_args(Rc, tc, sc))                   # (E, 7)

    def blocks(Rc, tc, sc):
        """Per-edge residuals and (7, 7) Jacobian blocks wrt both vertices."""
        args = edge_args(Rc, tc, sc)
        J = _edge_jacobians(z14, *args)                              # (E, 7, 14)
        return _res_k(z14, *args), J[..., 0:7], J[..., 7:14]

    def gradient(r_e, Ji, Jj):
        """g = -J^T r scattered per incident vertex, (K, 7)."""
        return -(_seg_sum(K, ii, torch.einsum("eab,ea->eb", Ji, r_e)) +
                 _seg_sum(K, jj, torch.einsum("eab,ea->eb", Jj, r_e)))

    def solve_dense(Rc, tc, sc, lam):
        r_e, Ji, Jj = blocks(Rc, tc, sc)
        H = torch.zeros((K, 7, K, 7), dtype=dt, device=dev)
        for a, Ja in ((ii, Ji), (jj, Jj)):
            for b, Jb in ((ii, Ji), (jj, Jj)):
                _add_blocks(H, a, b, torch.einsum("eka,ekb->eab", Ja, Jb))
        # pin fixed vertices and masked-out components
        H = H.reshape(K * 7, K * 7) + torch.diag(diag_pin.reshape(-1)) + \
            lam * torch.eye(K * 7, dtype=dt, device=dev)
        g = gradient(r_e, Ji, Jj).reshape(-1, 1)
        return torch.linalg.solve_ex(H, g).result.reshape(K, 7)

    def solve_cg(Rc, tc, sc, lam):
        r_e, Ji, Jj = blocks(Rc, tc, sc)
        g = gradient(r_e, Ji, Jj)
        # block diagonal of H for the preconditioner
        Hd = _seg_sum(K, ii, torch.einsum("eab,eac->ebc", Ji, Ji)) + \
            _seg_sum(K, jj, torch.einsum("eab,eac->ebc", Jj, Jj))
        Hd = Hd + torch.diag_embed(diag_pin + lam)
        Hd_inv = torch.linalg.inv_ex(Hd + 1e-8 * eye7).inverse

        def matvec(x):                                               # (K, 7)
            y = torch.einsum("eab,eb->ea", Ji, x[ii]) + torch.einsum("eab,eb->ea", Jj, x[jj])
            return _seg_sum(K, ii, torch.einsum("eab,ea->eb", Ji, y)) + \
                _seg_sum(K, jj, torch.einsum("eab,ea->eb", Jj, y)) + x * (diag_pin + lam)

        precond = lambda r: torch.einsum("kab,kb->ka", Hd_inv, r)
        x = torch.zeros_like(g)
        r = g
        z = precond(r)
        p = z
        for _ in range(cg_iters):
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

    step = solve_dense if solver == "dense" else solve_cg
    Rc, tc, sc = R, t, s
    lam = torch.full((), lam0, dtype=dt, device=dev)
    cost = torch.full((), float("inf"), dtype=dt, device=dev)
    for _ in range(iterations):
        dx = step(Rc, tc, sc, lam)
        R2, t2, s2 = _sim3_apply_delta(Rc, tc, sc[:, None], dx * free_c)
        R2, s2 = lie.normalize_rotation(R2), s2[:, 0]
        c_old = torch.sum(residuals(Rc, tc, sc) ** 2)
        c_upd = torch.sum(residuals(R2, t2, s2) ** 2)
        ok = c_upd < c_old
        Rc = torch.where(ok, R2, Rc)
        tc = torch.where(ok, t2, tc)
        sc = torch.where(ok, s2, sc)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 5.0), 1e-9, 1e9)
        cost = torch.minimum(c_upd, c_old)
    return PoseGraphResult(R=Rc, t=tc, s=sc, cost=cost)
