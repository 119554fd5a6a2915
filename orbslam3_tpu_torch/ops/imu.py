"""On-manifold IMU preintegration (Forster et al.).

Counterpart of `orbslam3_tpu/ops/imu.py` (reference src/ImuTypes.cc:179-240
IntegrateNewMeasurement, :86 IntegratedRotation, :285+ the bias-corrected
getters).  The JAX package runs the integration as a masked `lax.scan` over
a fixed-capacity buffer; here it is a Python loop of the same update, one
row after another.  A masked row is an exact no-op in both.  The host built
the rows and knows how many are valid: given `n_valid`, the loop runs over
that prefix only and never touches the padding, with the same numbers as
the masked loop over every row.

State layout (float32): dR (3,3); dV, dP (3,); JRg, JVg, JVa, JPg, JPa
(3,3); C (15,15) over [rot, vel, pos, gyro walk, acc walk]; dT (); avg_a,
avg_w (3,); b (6,) the linearization bias [gyro(3), acc(3)].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import lie


class ImuCalib(NamedTuple):
    """Discrete-time IMU noise (already scaled by sqrt(freq)), 0-d tensors."""
    sigma_g: torch.Tensor   # gyro noise
    sigma_a: torch.Tensor   # accel noise
    sigma_gw: torch.Tensor  # gyro walk
    sigma_aw: torch.Tensor  # accel walk
    Tbc_R: torch.Tensor     # (3,3) camera -> body rotation
    Tbc_t: torch.Tensor     # (3,) camera -> body translation

    @staticmethod
    def create(noise_gyro, noise_acc, walk_gyro, walk_acc, freq,
               Tbc_R=None, Tbc_t=None, device="cpu"):
        f32 = np.float32
        sf = np.sqrt(f32(freq))
        on = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        return ImuCalib(
            sigma_g=on(f32(noise_gyro) * sf), sigma_a=on(f32(noise_acc) * sf),
            sigma_gw=on(f32(walk_gyro) / sf), sigma_aw=on(f32(walk_acc) / sf),
            Tbc_R=on(np.eye(3) if Tbc_R is None else np.asarray(Tbc_R, np.float32)),
            Tbc_t=on(np.zeros(3) if Tbc_t is None else np.asarray(Tbc_t, np.float32)))


class Preintegrated(NamedTuple):
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor
    dT: torch.Tensor
    avg_a: torch.Tensor
    avg_w: torch.Tensor
    b: torch.Tensor  # linearization bias [gyro(3), acc(3)]


GRAVITY_MAGNITUDE = 9.81


def gravity(device) -> torch.Tensor:
    """World gravity (0, 0, -9.81) on `device` (the JAX package's GRAVITY)."""
    return torch.tensor([0.0, 0.0, -GRAVITY_MAGNITUDE], dtype=torch.float32, device=device)


def init_preintegrated(bias: Optional[torch.Tensor] = None, device="cpu") -> Preintegrated:
    if bias is None:
        bias = torch.zeros(6, dtype=torch.float32, device=device)
    dev = bias.device
    z3 = torch.zeros((3, 3), dtype=torch.float32, device=dev)
    z = torch.zeros(3, dtype=torch.float32, device=dev)
    return Preintegrated(
        dR=torch.eye(3, dtype=torch.float32, device=dev), dV=z, dP=z,
        JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3,
        C=torch.zeros((15, 15), dtype=torch.float32, device=dev),
        dT=torch.zeros((), dtype=torch.float32, device=dev),
        avg_a=z, avg_w=z, b=bias)


def _noise(calib: ImuCalib):
    """(Nga (6,6) measurement noise, walk (6,) bias random walk) variances."""
    g, a = calib.sigma_g ** 2, calib.sigma_a ** 2
    gw, aw = calib.sigma_gw ** 2, calib.sigma_aw ** 2
    nga = torch.diag(torch.stack([g, g, g, a, a, a]))
    walk = torch.stack([gw, gw, gw, aw, aw, aw])
    return nga, walk


def integrate_step(st: Preintegrated, acc, gyro, dt, calib: ImuCalib,
                   valid: Optional[torch.Tensor] = None, noise=None) -> Preintegrated:
    """One measurement update; `valid` False (a 0-d bool tensor) makes it an
    exact no-op, None means valid.  `noise` is `_noise(calib)`, computed once
    by a caller that loops."""
    nga, walk = _noise(calib) if noise is None else noise
    if valid is not None:
        dt = torch.where(valid, dt, 0.0)
    bg, ba = st.b[:3], st.b[3:]
    a = acc - ba
    w = gyro - bg

    denom = st.dT + dt
    safe = torch.where(denom > 0, denom, 1.0)
    Ra = st.dR @ a
    avg_a = torch.where(denom > 0, (st.dT * st.avg_a + Ra * dt) / safe, st.avg_a)
    avg_w = torch.where(denom > 0, (st.dT * st.avg_w + w * dt) / safe, st.avg_w)

    # position and velocity use the pre-update rotation
    dP = st.dP + st.dV * dt + 0.5 * Ra * dt * dt
    dV = st.dV + Ra * dt

    dRdt = st.dR * dt
    RW = dRdt @ lie.hat(a)
    RWJ = RW @ st.JRg
    JPa = st.JPa + st.JVa * dt - 0.5 * dRdt * dt
    JPg = st.JPg + st.JVg * dt - 0.5 * dt * RWJ
    JVa = st.JVa - dRdt
    JVg = st.JVg - RWJ

    wdt = w * dt
    dRi, rightJ = lie.exp_so3(wdt), lie.right_jacobian_so3(wdt)
    dR = lie.normalize_rotation(st.dR @ dRi)

    # covariance propagation over x = [rot, vel, pos]
    eye3 = torch.eye(3, dtype=torch.float32, device=a.device)
    z3 = torch.zeros_like(eye3)
    A = torch.cat([torch.cat([dRi.T, z3, z3], 1),
                   torch.cat([-RW, eye3, z3], 1),
                   torch.cat([-0.5 * dt * RW, eye3 * dt, eye3], 1)], 0)
    B = torch.cat([torch.cat([rightJ * dt, z3], 1),
                   torch.cat([z3, dRdt], 1),
                   torch.cat([z3, 0.5 * dRdt * dt], 1)], 0)
    C99 = A @ st.C[:9, :9] @ A.T + B @ nga @ B.T
    w6 = walk if valid is None else walk * torch.where(valid, 1.0, 0.0)
    C = torch.cat([torch.cat([C99, st.C[:9, 9:]], 1),
                   torch.cat([st.C[9:, :9], st.C[9:, 9:] + torch.diag(w6)], 1)], 0)

    JRg = dRi.T @ st.JRg - rightJ * dt
    new = Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg,
                        JPa=JPa, C=C, dT=st.dT + dt, avg_a=avg_a, avg_w=avg_w, b=st.b)
    if valid is None:
        return new
    return Preintegrated(*(torch.where(valid, n, o) for n, o in zip(new, st)))


def preintegrate(acc, gyro, dt, mask, calib: ImuCalib, bias=None,
                 n_valid: Optional[int] = None) -> Preintegrated:
    """Integrate a batch of measurements: acc, gyro (N, 3); dt, mask (N,).

    Masked rows are no-ops.  `n_valid` (a host int) says that `mask` is True
    on exactly the first `n_valid` rows, as `inertial_system.pack_imu_rows`
    lays them out: the loop then runs over those rows only.  Without it
    every row is integrated under its mask."""
    st = init_preintegrated(bias, device=acc.device)
    noise = _noise(calib)
    if n_valid is not None:
        for i in range(min(n_valid, acc.shape[0])):
            st = integrate_step(st, acc[i], gyro[i], dt[i], calib, noise=noise)
        return st
    for i in range(acc.shape[0]):
        st = integrate_step(st, acc[i], gyro[i], dt[i], calib, valid=mask[i], noise=noise)
    return st


def reintegrate(calib: ImuCalib, new_bias, acc, gyro, dt, mask,
                n_valid: Optional[int] = None) -> Preintegrated:
    """Re-run the integration at a new linearization bias (reference
    Preintegrated::Reintegrate)."""
    return preintegrate(acc, gyro, dt, mask, calib, new_bias, n_valid=n_valid)


# --- bias-corrected getters (reference ImuTypes.cc:285-330) ------------------

def delta_rotation(st: Preintegrated, bias) -> torch.Tensor:
    dbg = bias[:3] - st.b[:3]
    return lie.normalize_rotation(st.dR @ lie.exp_so3(st.JRg @ dbg))


def delta_velocity(st: Preintegrated, bias) -> torch.Tensor:
    dbg, dba = bias[:3] - st.b[:3], bias[3:] - st.b[3:]
    return st.dV + st.JVg @ dbg + st.JVa @ dba


def delta_position(st: Preintegrated, bias) -> torch.Tensor:
    dbg, dba = bias[:3] - st.b[:3], bias[3:] - st.b[3:]
    return st.dP + st.JPg @ dbg + st.JPa @ dba


def predict_state(Rwb1, twb1, v1, bias, st: Preintegrated, g=None):
    """IMU state prediction from state 1 over the preintegrated interval
    (reference Tracking::PredictStateIMU, src/Tracking.cc:293-350):
      R2 = R1 dR(b),  v2 = v1 + g t + R1 dV(b),  p2 = p1 + v1 t + .5 g t^2 + R1 dP(b)."""
    g = gravity(Rwb1.device) if g is None else g
    t = st.dT
    R2 = lie.normalize_rotation(Rwb1 @ delta_rotation(st, bias))
    v2 = v1 + g * t + Rwb1 @ delta_velocity(st, bias)
    t2 = twb1 + v1 * t + 0.5 * g * t * t + Rwb1 @ delta_position(st, bias)
    return R2, t2, v2
