"""Inertial factors and the inertial-only initialization.

Counterpart of `orbslam3_tpu/solver/inertial.py` (reference
src/Optimizer.cc, include/G2oTypes.h):
  * EdgeInertial (G2oTypes.h:495): the 9-dof preintegration residual
    between two body states [r_R, r_v, r_p]:
       r_R = Log( dR(b)^T R1^T R2 )
       r_v = R1^T (v2 - v1 - g dt)        - dV(b)
       r_p = R1^T (p2 - p1 - v1 dt - 0.5 g dt^2) - dP(b)
    with the inverse of the preintegration covariance as information;
  * InertialOptimization (Optimizer.cc:2964): poses fixed; velocities, one
    shared gyro + acc bias, the 2-dof gravity direction and the log-scale
    by Levenberg-Marquardt over the factors, priors on the biases.

The residuals broadcast over leading dimensions, so a stack of factors is
one batched evaluation; Jacobians come from `torch.func.jacfwd` as the JAX
package takes them from `jax.jacfwd` (through `jacobian`, which keeps them
float32).  The inverses and the solve use the
`_ex` variants, which never read a status back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from ..ops import imu as imu_ops
from ..ops import lie
from ..slam_map.state import _upload

GRAVITY_MAG = 9.81


class PreintFactor(NamedTuple):
    """Preintegrations between keyframes (kf_i -> kf_j), stacked."""
    dR: torch.Tensor     # (F,3,3)
    dV: torch.Tensor     # (F,3)
    dP: torch.Tensor     # (F,3)
    JRg: torch.Tensor    # (F,3,3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor      # (F,15,15)
    dT: torch.Tensor     # (F,)
    b0: torch.Tensor     # (F,6) linearization bias
    kf_i: torch.Tensor   # (F,) int32 source keyframe
    kf_j: torch.Tensor   # (F,) int32 target keyframe
    valid: torch.Tensor  # (F,) bool


_PRE = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C", "dT")


def stack_preints(preints: list, kf_i: list, kf_j: list, capacity: int) -> PreintFactor:
    """Stack Preintegrated states into a factor stack of `capacity` rows,
    the rows past the list zero and invalid (the JAX package's host-side
    `stack_preints`)."""
    n = min(len(preints), capacity)
    dev = preints[0].dR.device if preints else torch.device("cpu")
    base = imu_ops.init_preintegrated(device=dev)
    rows = list(preints[:n])

    def col(get):
        return torch.stack([get(s) for s in rows] + [torch.zeros_like(get(base))] * (capacity - n))

    fields = {k: col(lambda s, k=k: getattr(s, k)) for k in _PRE}
    fields["b0"] = col(lambda s: s.b)
    idx = lambda v: torch.tensor(list(v[:n]) + [0] * (capacity - n), dtype=torch.int32,
                                 device=dev)
    return PreintFactor(**fields, kf_i=idx(kf_i), kf_j=idx(kf_j),
                        valid=torch.arange(capacity, device=dev) < n)


def stack_preints_device(preints: list, kf_i: list, kf_j: list,
                         capacity: int | None = None) -> PreintFactor:
    """The factor stack on the device: one `torch.stack` per field and one
    upload of the keyframe indices that does not wait for the device.  The
    JAX package pads the list to `capacity` by repeating its first entry (a
    jit shape); here `capacity` None stacks exactly the list, and a padding
    row is masked by `valid` either way."""
    n = len(preints) if capacity is None else min(len(preints), capacity)
    F = n if capacity is None else capacity
    sel = list(preints[:n])
    if not sel:
        sel = [imu_ops.init_preintegrated()]
    sel = sel + [sel[0]] * (F - len(sel))
    dev = sel[0].dR.device
    pad = [0] * (F - n)
    ij = _upload(np.asarray([list(kf_i[:n]) + pad, list(kf_j[:n]) + pad], np.int32), dev)
    return PreintFactor(**{k: torch.stack([getattr(s, k) for s in sel]) for k in _PRE},
                        b0=torch.stack([s.b for s in sel]), kf_i=ij[0], kf_j=ij[1],
                        valid=torch.arange(F, device=dev) < n)


def factor_from_preint(pre: imu_ops.Preintegrated, kf_i: int = 0, kf_j: int = 1) -> PreintFactor:
    """A one-row factor stack from one Preintegrated, nothing read or
    uploaded."""
    dev = pre.dR.device
    return PreintFactor(
        **{k: getattr(pre, k)[None] for k in _PRE}, b0=pre.b[None],
        kf_i=torch.full((1,), kf_i, dtype=torch.int32, device=dev),
        kf_j=torch.full((1,), kf_j, dtype=torch.int32, device=dev),
        valid=torch.ones(1, dtype=torch.bool, device=dev))


def select(f: PreintFactor, k) -> PreintFactor:
    """Row(s) k of a factor stack."""
    return PreintFactor(*(x[k] for x in f))


def gravity_from_dir(gdir: torch.Tensor) -> torch.Tensor:
    """2-dof gravity direction -> world gravity vector (reference
    VertexGDir: Rwg * [0, 0, -G], Rwg = Exp([gx, gy, 0]))."""
    Rwg = lie.exp_so3(torch.cat([gdir, torch.zeros_like(gdir[:1])]))
    return Rwg[:, 2] * -GRAVITY_MAG    # Rwg @ [0, 0, -G], exactly


def factor_residual(f: PreintFactor, Rwb1, p1, v1, Rwb2, p2, v2, bias, g):
    """9-dof residual of the factor(s) `f` at the given states, broadcast
    over leading dimensions (bias-corrected deltas through the first-order
    Jacobians, reference EdgeInertial::computeError)."""
    mv = lie._mv
    db = bias - f.b0
    dbg, dba = db[..., :3], db[..., 3:]
    dR = f.dR @ lie.exp_so3(mv(f.JRg, dbg))
    dV = f.dV + mv(f.JVg, dbg) + mv(f.JVa, dba)
    dP = f.dP + mv(f.JPg, dbg) + mv(f.JPa, dba)
    dt = f.dT[..., None]
    R1t = Rwb1.transpose(-1, -2)
    r_R = lie.log_so3(dR.transpose(-1, -2) @ (R1t @ Rwb2))
    r_v = mv(R1t, v2 - v1 - g * dt) - dV
    r_p = mv(R1t, p2 - p1 - v1 * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([r_R, r_v, r_p], dim=-1)


def inertial_residual(f: PreintFactor, k, Rwb1, p1, v1, Rwb2, p2, v2, bias, g):
    """The residual of factor k of the stack (the JAX signature)."""
    return factor_residual(select(f, k), Rwb1, p1, v1, Rwb2, p2, v2, bias, g)


def jacobian(fn, x: torch.Tensor, *args, argnums=0):
    """`torch.func.jacfwd(fn, argnums)(x, *args)`, cast to x's dtype.  torch
    2.13's forward mode gives a 0-d float32 tensor combined with a Python
    float a float64 tangent (`lie.log_so3` avoids 0-d scalars for that
    reason); the cast keeps any such Jacobian float32, as JAX's are."""
    J = jacfwd(fn, argnums=argnums)(x, *args)
    return tuple(j.to(x.dtype) for j in J) if isinstance(J, tuple) else J.to(x.dtype)


def info_from_cov(C9: torch.Tensor) -> torch.Tensor:
    """Symmetrized inverse of the 9x9 preintegration covariance block(s)
    (reference EdgeInertial ctor)."""
    eye = torch.eye(C9.shape[-1], dtype=C9.dtype, device=C9.device)
    C = 0.5 * (C9 + C9.transpose(-1, -2)) + eye * 1e-9
    inv = torch.linalg.inv_ex(C).inverse
    return 0.5 * (inv + inv.transpose(-1, -2))


class InertialInitResult(NamedTuple):
    scale: torch.Tensor      # ()
    Rwg: torch.Tensor        # (3,3) gravity rotation
    bias: torch.Tensor       # (6,) shared [gyro, acc]
    vel: torch.Tensor        # (K,3) body velocities
    cost: torch.Tensor


def inertial_only_init(f: PreintFactor, Rwb: torch.Tensor, pwb: torch.Tensor,
                       kf_valid: torch.Tensor, prior_g: float = 1e2, prior_a: float = 1e6,
                       iterations: int = 50, fix_scale: bool = False) -> InertialInitResult:
    """Inertial-only initialization (reference InertialOptimization,
    src/Optimizer.cc:2964): the body poses Rwb/pwb (K,3,3)/(K,3) are fixed
    up to a global scale and the gravity rotation; velocities, one shared
    bias, the gravity direction and the log-scale are solved by LM over the
    factors (3K + 9 unknowns).  A caller may pass only the keyframes that
    the factors name: the other velocities have no residual and stay 0."""
    K = Rwb.shape[0]
    dev, dt = Rwb.device, Rwb.dtype
    ki, kj = f.kf_i.long(), f.kf_j.long()
    W = info_from_cov(f.C[:, :9, :9])                                   # (F,9,9)
    eye9 = torch.eye(9, dtype=dt, device=dev)
    L = torch.linalg.cholesky_ex(W + eye9 * 1e-12).L
    R_i, R_j, p_i, p_j = Rwb[ki], Rwb[kj], pwb[ki], pwb[kj]
    on = f.valid[:, None]
    sg, sa = prior_g ** 0.5, prior_a ** 0.5

    def residuals(x):
        vel = x[: 3 * K].reshape(K, 3)
        bias = x[3 * K: 3 * K + 6]
        g = gravity_from_dir(x[3 * K + 6: 3 * K + 8])
        s = 1.0 if fix_scale else torch.exp(x[3 * K + 8])
        r = factor_residual(f, R_i, s * p_i, vel[ki], R_j, s * p_j, vel[kj], bias, g)
        r = torch.where(on, lie._mv(L, r), 0.0)
        return torch.cat([r.reshape(-1), sg * bias[:3], sa * bias[3:]])

    n = 3 * K + 9
    eye = torch.eye(n, dtype=dt, device=dev)
    x = torch.zeros(n, dtype=dt, device=dev)
    lam = torch.full((), 1e-2, dtype=dt, device=dev)
    cost = torch.full((), float("inf"), dtype=dt, device=dev)
    for _ in range(iterations):
        r = residuals(x)
        J = jacobian(residuals, x)
        H = J.T @ J
        b = -(J.T @ r)
        dx = torch.linalg.solve_ex(H + lam * eye, b).result
        x_new = x + dx
        c_new = torch.sum(residuals(x_new) ** 2)
        c_old = torch.sum(r ** 2)
        ok = c_new < c_old
        x = torch.where(ok, x_new, x)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 5.0), 1e-9, 1e9)
        cost = torch.minimum(c_new, c_old)
    gdir = x[3 * K + 6: 3 * K + 8]
    return InertialInitResult(
        scale=torch.ones((), dtype=dt, device=dev) if fix_scale else torch.exp(x[3 * K + 8]),
        Rwg=lie.exp_so3(torch.cat([gdir, torch.zeros_like(gdir[:1])])),
        bias=x[3 * K: 3 * K + 6], vel=x[: 3 * K].reshape(K, 3), cost=cost)
