"""The reference's optimizers: NumPy in float64, independent of the program.

Each check here takes a problem that the program solved inside the timed
path (or, for the IMU initialization, in set-up), works out its inputs
again where the benchmark made them (IMU samples, camera, noise model), and
solves it in float64 to convergence.  What it reports is the share of the
work the program left undone:

    undone = (C(returned) - C*) / (C(start) - C*)

with C the problem's cost in float64, C* its optimum and `start` the state
the program was handed.  A solver that returns its input unchanged reads 1;
one that converged reads the rounding of its own arithmetic.

* `ba_undone`: the keyframe step's window bundle adjustment (Huber on each
  observation's chi2, g2o's RobustKernelHuber at sqrt(5.991)), cameras and
  points of the window, fixed cameras held;
* `vi_undone`: the visual-inertial pose optimization of a tracked frame
  (ORB-SLAM3's PoseInertialOptimizationLastKeyFrame and ...LastFrame): the
  frame's reprojection errors over its returned inliers, the preintegrated
  IMU factor from the samples the benchmark fed, the bias random walk and,
  for the LastFrame form, the previous frame's marginalized prior (the
  program's state, taken as it stands);
* `init_undone`: the inertial-only initialization (ORB-SLAM3's
  InertialOptimization): velocities, one bias, the gravity direction and
  the scale against the keyframes' preintegrated factors and the bias
  priors, the keyframe poses fixed (the program's state).

The preintegration is Forster et al.'s on-manifold scheme as ORB-SLAM3
integrates it (ImuTypes.cc IntegrateNewMeasurement), over the integration
steps of Tracking::PreintegrateIMU (midpoint values, the interval's ends
interpolated), with the bias correction of the deltas to first order.
"""

from __future__ import annotations

import math

import numpy as np

GRAVITY = np.array([0.0, 0.0, -9.81])
HUBER_MONO = math.sqrt(5.991)


# ------------------------------------------------------------------- SO(3)
def hat(v):
    v = np.asarray(v, np.float64)
    out = np.zeros(v.shape[:-1] + (3, 3))
    out[..., 0, 1], out[..., 0, 2] = -v[..., 2], v[..., 1]
    out[..., 1, 0], out[..., 1, 2] = v[..., 2], -v[..., 0]
    out[..., 2, 0], out[..., 2, 1] = -v[..., 1], v[..., 0]
    return out


def exp_so3(w):
    """Rodrigues, batched over leading dimensions."""
    w = np.asarray(w, np.float64)
    th2 = np.sum(w * w, axis=-1)[..., None, None]
    th = np.sqrt(th2)
    small = th2 < 1e-16
    a = np.where(small, 1.0 - th2 / 6.0, np.sin(th) / np.where(small, 1.0, th))
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / np.where(small, 1.0, th2))
    K = hat(w)
    return np.eye(3) + a * K + b * (K @ K)


def log_so3(R):
    R = np.asarray(R, np.float64)
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = math.acos(c)
    v = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-8:
        return v
    if math.pi - th < 1e-6:
        # the axis from the symmetric part
        A = 0.5 * (R + np.eye(3))
        k = int(np.argmax(np.diag(A)))
        axis = A[:, k] / math.sqrt(max(A[k, k], 1e-300))
        return axis * th
    return v * th / math.sin(th)


def right_jacobian(w):
    w = np.asarray(w, np.float64)
    th2 = float(w @ w)
    K = hat(w)
    if th2 < 1e-12:
        return np.eye(3) - 0.5 * K + K @ K / 6.0
    th = math.sqrt(th2)
    return np.eye(3) - (1.0 - math.cos(th)) / th2 * K + (th - math.sin(th)) / (th2 * th) * K @ K


def project(K4, Xc):
    fx, fy, cx, cy = K4
    return np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fy * Xc[..., 1] / Xc[..., 2] + cy], -1)


def project_jac(K4, Xc):
    fx, fy = K4[0], K4[1]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    J = np.zeros(Xc.shape[:-1] + (2, 3))
    J[..., 0, 0] = fx / z
    J[..., 0, 2] = -fx * x / (z * z)
    J[..., 1, 1] = fy / z
    J[..., 1, 2] = -fy * y / (z * z)
    return J


# ---------------------------------------------------------- preintegration
def imu_steps(samples, t0: float, t1: float, nxt=None):
    """Integration steps over (t0, t1] (ORB-SLAM3 Tracking::PreintegrateIMU):
    `samples` the (t, gyro, acc) with t0 < t <= t1 in time order, `nxt` the
    first sample after t1 if one had arrived.  Returns (acc, gyr, dt)
    float64 arrays, or None without samples."""
    pts = [(float(t), np.asarray(g, np.float64), np.asarray(a, np.float64))
           for t, g, a in samples] + ([nxt] if nxt is not None else [])
    n = len(pts) - 1
    if n < 0:
        return None
    if n == 0:
        t, g, a = pts[0]
        return a[None], g[None], np.array([max(t1 - t0, 0.0)])
    acc, gyr, dts = np.zeros((n, 3)), np.zeros((n, 3)), np.zeros(n)
    for i in range(n):
        ti, gi, ai = pts[i]
        tj, gj, aj = pts[i + 1]
        tab = max(tj - ti, 1e-9)
        if i == 0 and i < n - 1:
            w = (ti - t0) / tab
            a, g, dt = 0.5 * (ai + aj - (aj - ai) * w), 0.5 * (gi + gj - (gj - gi) * w), tj - t0
        elif i < n - 1:
            a, g, dt = 0.5 * (ai + aj), 0.5 * (gi + gj), tab
        elif i > 0:
            w = (tj - t1) / tab
            a, g, dt = 0.5 * (ai + aj - (aj - ai) * w), 0.5 * (gi + gj - (gj - gi) * w), t1 - ti
        else:
            a, g, dt = ai, gi, t1 - t0
        acc[i], gyr[i], dts[i] = a, g, max(dt, 0.0)
    return acc, gyr, dts


def discrete_noise(noise: dict) -> tuple:
    """(Nga (6,6), walk (6,)) per step from continuous densities and the
    IMU rate (ORB-SLAM3 scales the noise by sqrt(f), the walk by 1/sqrt(f))."""
    sf = math.sqrt(float(noise["imu_freq"]))
    g, a = (noise["noise_gyro"] * sf) ** 2, (noise["noise_acc"] * sf) ** 2
    gw, aw = (noise["walk_gyro"] / sf) ** 2, (noise["walk_acc"] / sf) ** 2
    return np.diag([g, g, g, a, a, a]), np.array([gw, gw, gw, aw, aw, aw])


def preintegrate(steps, bias, noise: dict) -> dict:
    """The preintegrated deltas, their bias Jacobians and covariance over
    [rot, vel, pos, gyro walk, acc walk] at the linearization bias."""
    acc, gyr, dts = steps
    b = np.asarray(bias, np.float64)
    Nga, walk = discrete_noise(noise)
    dR, dV, dP = np.eye(3), np.zeros(3), np.zeros(3)
    JRg, JVg, JVa, JPg, JPa = (np.zeros((3, 3)) for _ in range(5))
    C = np.zeros((15, 15))
    T = 0.0
    I3 = np.eye(3)
    for a_m, g_m, dt in zip(acc, gyr, dts):
        a, w = a_m - b[3:], g_m - b[:3]
        dP = dP + dV * dt + 0.5 * dR @ a * dt * dt
        dV = dV + dR @ a * dt
        Wa = hat(a)
        A = np.eye(9)
        A[3:6, 0:3] = -dR @ Wa * dt
        A[6:9, 0:3] = -0.5 * dR @ Wa * dt * dt
        A[6:9, 3:6] = I3 * dt
        B = np.zeros((9, 6))
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt * dt
        JPa = JPa + JVa * dt - 0.5 * dR * dt * dt
        JPg = JPg + JVg * dt - 0.5 * dR @ Wa @ JRg * dt * dt
        JVa = JVa - dR * dt
        JVg = JVg - dR @ Wa @ JRg * dt
        dRi = exp_so3(w * dt)
        Jr = right_jacobian(w * dt)
        dR = dR @ dRi
        U, _, Vt = np.linalg.svd(dR)
        dR = U @ Vt
        A[0:3, 0:3] = dRi.T
        B[0:3, 0:3] = Jr * dt
        C[:9, :9] = A @ C[:9, :9] @ A.T + B @ Nga @ B.T
        C[9:, 9:] += np.diag(walk)
        JRg = dRi.T @ JRg - Jr * dt
        T += dt
    return dict(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, C=C, dT=T,
                b=b)


def inertial_residual(pre: dict, R1, p1, v1, R2, p2, v2, bias, g=GRAVITY):
    """EdgeInertial's 9-dof error [r_R, r_v, r_p] with the deltas corrected
    to the first bias state to first order."""
    db = np.asarray(bias, np.float64) - pre["b"]
    dR = pre["dR"] @ exp_so3(pre["JRg"] @ db[:3])
    dV = pre["dV"] + pre["JVg"] @ db[:3] + pre["JVa"] @ db[3:]
    dP = pre["dP"] + pre["JPg"] @ db[:3] + pre["JPa"] @ db[3:]
    T = pre["dT"]
    return np.concatenate([log_so3(dR.T @ R1.T @ R2), R1.T @ (v2 - v1 - g * T) - dV,
                           R1.T @ (p2 - p1 - v1 * T - 0.5 * g * T * T) - dP])


def sqrt_info(C, eps: float):
    """Upper factor L^T with L L^T = (C sym + eps I)^-1 symmetrized."""
    n = C.shape[0]
    inv = np.linalg.inv(0.5 * (C + C.T) + np.eye(n) * eps)
    return np.linalg.cholesky(0.5 * (inv + inv.T)).T


# ------------------------------------------------- a small least squares
def _solve_small(res, x0, max_iter: int = 100):
    """Levenberg-Marquardt on a residual function of a short vector, with
    central-difference Jacobians.  Returns (x, cost)."""
    x = np.asarray(x0, np.float64).copy()
    r = res(x)
    cost = float(r @ r)
    lam = 1e-6
    for _ in range(max_iter):
        h = 1e-6 * np.maximum(1.0, np.abs(x))
        J = np.stack([(res(x + e) - res(x - e)) / (2 * e[k]) for k, e in
                      enumerate(np.diag(h))], 1)
        H, b = J.T @ J, -(J.T @ r)
        improved = False
        for _ in range(12):
            dx = np.linalg.solve(H + lam * np.diag(np.maximum(np.diag(H), 1e-12)), b)
            r2 = res(x + dx)
            c2 = float(r2 @ r2)
            if c2 < cost:
                x, r, step, cost = x + dx, r2, dx, c2
                lam = max(lam * 0.3, 1e-12)
                improved = True
                break
            lam *= 10.0
        if not improved or np.max(np.abs(step)) < 1e-13 * max(1.0, np.max(np.abs(x))):
            break
    return x, cost


def undone(c_returned: float, c_start: float, c_opt: float) -> float:
    c_opt = min(c_opt, c_returned, c_start)
    return (c_returned - c_opt) / max(c_start - c_opt, 1e-300)


# ------------------------------------------------ the VI pose optimization
def _retract(state, d):
    R, p, v, b = state
    return (R @ exp_so3(d[0:3]), p + d[3:6], v + d[6:9], b + d[9:15])


def vi_pose_problem(call: dict, samples, noise: dict, K4, Tbc, scale_factor: float) -> dict:
    """The cost of one captured VI pose optimization as a residual function
    of the update from the states the program was handed: the frame's 15
    dof (LastKeyFrame), or the previous frame's 15 then the frame's
    (LastFrame)."""
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    Rcb = Rbc.T
    tcb = -Rcb @ tbc
    pre = preintegrate(imu_steps(samples, call["t0"], call["t1"]), call["bias0"], noise)
    L9 = sqrt_info(pre["C"][:9, :9], 1e-9)
    Lb = np.linalg.cholesky(np.linalg.inv(pre["C"][9:, 9:] + np.eye(6) * 1e-12)).T
    X, uv = call["X"], call["uv"]
    w = scale_factor ** -np.asarray(call["octave"], np.float64)

    def visual(R, p):
        Xc = (X - p) @ R @ Rcb.T + tcb
        return ((uv - project(K4, Xc)) * w[:, None]).reshape(-1)

    start = (call["R0"], call["p0"], call["v0"], call["b0"])
    if call["kind"] == "lastkf":
        kf = call["kf"]

        def res(d):
            R, p, v, b = _retract(start, d)
            r9 = inertial_residual(pre, kf[0], kf[1], kf[2], R, p, v, kf[3])
            return np.concatenate([visual(R, p), L9 @ r9, Lb @ (b - kf[3])])
        return dict(res=res, n=15, start=start)
    pr = call["prior"]
    ev, V = np.linalg.eigh(0.5 * (pr["H"] + pr["H"].T) + np.eye(15) * 1e-6)
    Lp = np.sqrt(np.maximum(ev, 0.0))[:, None] * V.T
    prev0 = (pr["R"], pr["p"], pr["v"], pr["b"])

    def res(d):
        R1, p1, v1, b1 = _retract(prev0, d[:15])
        R, p, v, b = _retract(start, d[15:])
        r9 = inertial_residual(pre, R1, p1, v1, R, p, v, b1)
        rp = np.concatenate([log_so3(pr["R"].T @ R1), p1 - pr["p"], v1 - pr["v"], b1 - pr["b"]])
        return np.concatenate([visual(R, p), L9 @ r9, Lb @ (b - b1), Lp @ rp])
    return dict(res=res, n=30, start=start)


def _state_delta(a, b):
    """The update d with _retract(a, d) == b."""
    return np.concatenate([log_so3(a[0].T @ b[0]), b[1] - a[1], b[2] - a[2], b[3] - a[3]])


def check_vi_pose(call: dict, samples, noise: dict, K4, Tbc, scale_factor: float) -> dict:
    """`vi_undone` of one captured VI pose optimization, with the largest
    shift of an inlier's projection between the returned pose and the
    optimum's (pixels) beside it.  The program returns the frame's state
    alone, so in the LastFrame form a frame state costs what it costs with
    the best previous state beside it."""
    prob = vi_pose_problem(call, samples, noise, K4, Tbc, scale_factor)
    res = prob["res"]
    out = call["out"]
    d_out = _state_delta(prob["start"], (out["R"], out["p"], out["v"], out["b"]))
    if prob["n"] == 15:
        def cost_of(dc):
            return float(np.sum(res(dc) ** 2))
        x0 = d_out
    else:
        def cost_of(dc):
            return _solve_small(lambda dp: res(np.concatenate([dp, dc])), np.zeros(15))[1]
        x0 = np.concatenate([np.zeros(15), d_out])
    x_opt, c_opt = _solve_small(res, x0)
    c_out, c_in = cost_of(d_out), cost_of(np.zeros(15))
    R, p, _, _ = _retract(prob["start"], x_opt[-15:])
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    Rcb, tcb = Rbc.T, -Rbc.T @ tbc
    uv_o = project(K4, (call["X"] - p) @ R @ Rcb.T + tcb)
    uv_r = project(K4, (call["X"] - out["p"]) @ out["R"] @ Rcb.T + tcb)
    return dict(undone=undone(c_out, c_in, c_opt), gap_px=float(
        np.max(np.linalg.norm(uv_o - uv_r, axis=1))), kind=call["kind"], n=len(call["X"]))


# ------------------------------------------------------ the IMU initialization
def gravity_from_dir(gdir):
    return exp_so3(np.array([gdir[0], gdir[1], 0.0])) @ GRAVITY


def check_imu_init(call: dict, samples, noise: dict) -> dict:
    """`init_undone` of one captured inertial-only initialization, with the
    gaps of its gravity (degrees), scale, velocities and bias to the
    optimum's beside it."""
    K = call["Rwb"].shape[0]
    pres = []
    for (i, j), (t0, t1), b0 in zip(call["pairs"], call["times"], call["b0"]):
        sel = [s for s in samples if t0 < s[0] <= t1]
        pres.append((i, j, preintegrate(imu_steps(sel, t0, t1), b0, noise)))
    Ls = [sqrt_info(p["C"][:9, :9], 1e-9) for _, _, p in pres]
    sg, sa = math.sqrt(call["prior_g"]), math.sqrt(call["prior_a"])
    fix = call["fix_scale"]
    Rwb, pwb = call["Rwb"], call["pwb"]

    def res(x):
        vel = x[:3 * K].reshape(K, 3)
        bias = x[3 * K:3 * K + 6]
        g = gravity_from_dir(x[3 * K + 6:3 * K + 8])
        s = 1.0 if fix else math.exp(x[3 * K + 8])
        rs = [L @ inertial_residual(p, Rwb[i], s * pwb[i], vel[i], Rwb[j], s * pwb[j], vel[j],
                                    bias, g) for (i, j, p), L in zip(pres, Ls)]
        return np.concatenate(rs + [sg * bias[:3], sa * bias[3:]])

    out = call["out"]
    Rwg = out["Rwg"]
    gdir = log_so3(Rwg)[:2]
    x_out = np.concatenate([out["vel"].reshape(-1), out["bias"], gdir,
                            [math.log(max(out["scale"], 1e-300))]])
    x_opt, c_opt = _solve_small(res, x_out)
    c_out = float(np.sum(res(x_out) ** 2))
    c_in = float(np.sum(res(np.zeros(3 * K + 9)) ** 2))
    g_o, g_r = gravity_from_dir(x_opt[3 * K + 6:3 * K + 8]), Rwg @ GRAVITY
    ang = math.degrees(math.atan2(np.linalg.norm(np.cross(g_o, g_r)), g_o @ g_r))
    v_o, v_r = x_opt[:3 * K].reshape(K, 3), out["vel"]
    return dict(undone=undone(c_out, c_in, c_opt), gravity_deg=ang,
                scale_gap=abs(out["scale"] / math.exp(x_opt[3 * K + 8]) - 1.0),
                vel_gap=float(np.sqrt(np.mean(np.sum((v_o - v_r) ** 2, 1)) /
                                      max(np.mean(np.sum(v_o ** 2, 1)), 1e-300))),
                bias_gap=float(np.max(np.abs(x_opt[3 * K:3 * K + 6] - out["bias"]))))


# -------------------------------------------------- the window bundle adjustment
def _huber(chi2, delta=HUBER_MONO):
    e = np.sqrt(np.maximum(chi2, 1e-300))
    return np.where(e <= delta, chi2, 2.0 * delta * e - delta * delta)


def _ba_obs(prob):
    """The problem's observations as a list: point and camera of each,
    where the slot is occupied and both are valid."""
    p, k = np.nonzero(prob["mask"] > 0)
    return dict(p=p, k=k, uv=prob["uv"][p, k], inv_s2=prob["inv_s2"][p, k])


def _ba_residuals(obs, R, t, X, K4):
    """e (n,2), chi2 (n,) and the camera points (n,3) of the observations."""
    Xc = np.einsum("nab,nb->na", R[obs["k"]], X[obs["p"]]) + t[obs["k"]]
    e = obs["uv"] - project(K4, Xc)
    return e, np.sum(e * e, -1) * obs["inv_s2"], Xc


def _ba_cost(obs, R, t, X, K4):
    return float(np.sum(_huber(_ba_residuals(obs, R, t, X, K4)[1])))


def ba_optimum(prob: dict, R, t, X, K4, max_iter: int = 150):
    """Levenberg-Marquardt with the Schur complement on the points, from
    (R, t, X) (R_cw, t_cw of the window's cameras, the window's points),
    IRLS on the Huber kernel, the fixed cameras held.  Returns (R, t, X,
    cost)."""
    obs = _ba_obs(prob)
    pi, ki = obs["p"], obs["k"]
    P, K = prob["mask"].shape
    fidx = np.nonzero(~prob["fixed"] & prob["cam_valid"])[0]
    cost = _ba_cost(obs, R, t, X, K4)
    lam = 1e-4
    for _ in range(max_iter):
        e, chi2, Xc = _ba_residuals(obs, R, t, X, K4)
        ee = np.sqrt(np.maximum(chi2, 1e-300))
        w = obs["inv_s2"] * np.where(ee <= HUBER_MONO, 1.0, HUBER_MONO / ee)
        Jp = project_jac(K4, Xc)                                        # (n,2,3)
        # d(uv_pred)/d[rho, phi] for T' = exp(xi) T: Jp [I, -hat(Xc)]
        Jc = np.concatenate([Jp, -Jp @ hat(Xc)], -1)                    # (n,2,6)
        Jx = Jp @ R[ki]                                                 # (n,2,3)
        wJc, wJx = Jc * w[:, None, None], Jx * w[:, None, None]
        Hcc, bc = np.zeros((K, 6, 6)), np.zeros((K, 6))
        np.add.at(Hcc, ki, wJc.transpose(0, 2, 1) @ Jc)
        np.add.at(bc, ki, np.einsum("nia,ni->na", wJc, e))
        Hpp, bp = np.zeros((P, 3, 3)), np.zeros((P, 3))
        np.add.at(Hpp, pi, wJx.transpose(0, 2, 1) @ Jx)
        np.add.at(bp, pi, np.einsum("nia,ni->na", wJx, e))
        Hcp = wJc.transpose(0, 2, 1) @ Jx                               # (n,6,3)
        Hd = np.zeros((P, K, 6, 3))
        Hd[pi, ki] = Hcp
        improved = False
        for _ in range(12):
            Hpp_d = Hpp + lam * (np.eye(3) * np.maximum(np.trace(Hpp, axis1=1, axis2=2) / 3,
                                                        1e-9)[:, None, None])
            Hpp_i = np.linalg.inv(Hpp_d)
            W = Hcp @ Hpp_i[pi]                                         # (n,6,3)
            Wd = np.zeros((P, K, 6, 3))
            Wd[pi, ki] = W
            S = np.zeros((K, 6, K, 6))
            S[np.arange(K), :, np.arange(K), :] = Hcc + lam * np.eye(6) * np.maximum(
                np.trace(Hcc, axis1=1, axis2=2) / 6, 1e-9)[:, None, None]
            S -= (Wd.transpose(1, 2, 0, 3).reshape(K * 6, P * 3) @
                  Hd.transpose(0, 3, 1, 2).reshape(P * 3, K * 6)).reshape(K, 6, K, 6)
            rhs = bc.copy()
            np.add.at(rhs, ki, -(W @ bp[pi][..., None])[..., 0])
            Sf = S[fidx][:, :, fidx].reshape(len(fidx) * 6, len(fidx) * 6)
            dxc = np.zeros((K, 6))
            if len(fidx):
                dxc[fidx] = np.linalg.solve(Sf, rhs[fidx].reshape(-1)).reshape(-1, 6)
            back = np.zeros((P, 3))
            np.add.at(back, pi, (Hcp.transpose(0, 2, 1) @ dxc[ki][..., None])[..., 0])
            dxp = (Hpp_i @ (bp - back)[..., None])[..., 0] * prob["pt_valid"][:, None]
            dR = exp_so3(dxc[:, 3:])
            R2 = dR @ R
            t2 = np.einsum("kab,kb->ka", dR, t) + dxc[:, :3]
            X2 = X + dxp
            c2 = _ba_cost(obs, R2, t2, X2, K4)
            if c2 < cost:
                gain = cost - c2
                R, t, X, cost = R2, t2, X2, c2
                lam = max(lam * 0.3, 1e-12)
                improved = True
                break
            lam *= 10.0
        if not improved or gain < 1e-13 * cost:
            break
    return R, t, X, cost


def check_ba(call: dict, K4, scale_factor: float) -> dict:
    """`ba_undone` of one captured window BA, with the largest shift of an
    observation's projection between the returned state and the optimum
    (pixels) beside it.  Each observation's weight is worked out again from
    its pyramid level, which the program's weight names."""
    level = np.rint(-np.log(np.maximum(call["inv_s2"], 1e-30)) / (2 * math.log(scale_factor)))
    prob = dict(uv=call["uv"], inv_s2=scale_factor ** (-2.0 * level), fixed=call["fixed"],
                cam_valid=call["cam_valid"], pt_valid=call["pt_valid"],
                mask=(call["valid"] & call["pt_valid"][:, None] &
                      call["cam_valid"][None, :]).astype(np.float64))
    out = call["out"]
    obs = _ba_obs(prob)
    c_in = _ba_cost(obs, call["R"], call["t"], call["X"], K4)
    c_out = _ba_cost(obs, out["R"], out["t"], out["X"], K4)
    R, t, X, c_opt = ba_optimum(prob, out["R"], out["t"], out["X"], K4)
    uv_o = project(K4, _ba_residuals(obs, R, t, X, K4)[2])
    uv_r = project(K4, _ba_residuals(obs, out["R"], out["t"], out["X"], K4)[2])
    return dict(undone=undone(c_out, c_in, c_opt),
                gap_px=float(np.max(np.linalg.norm(uv_o - uv_r, axis=-1))) if len(uv_o) else 0.0,
                n_obs=int(len(obs["p"])), cams=int(prob["cam_valid"].sum()))
