"""The plain reference that decides `correct`: NumPy in float64.

It imports nothing of the program.  It is handed the inputs the benchmark
made (the frames, the true path and scene) and what the timed path produced
(keypoints and descriptors, poses, map points, the IMU state), and works
out again everything it compares them with:

* the ORB descriptor of each sampled keypoint, from the frame's own pyramid
  (the linear antialiased resize and the 5x5 Gaussian of the ORB front end,
  rounded to integers), its intensity-centroid angle, and the published
  256-pair ORB pattern rotated into 32 angle bins (`data/orb_pattern.json`);
* the pose-only optimization of each sampled tracked frame, ORB-SLAM3's
  motion-only BA on the frame's correspondences with the program's schedule,
  from the same start, and the least-squares optimum of its returned
  inliers;
* the trajectory's similarity alignment to the true path (Umeyama) and its
  RMSE, scale and tilt;
* the height of the map's new points above the true scene surface.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np

N_BINS = 32
HALF_PATCH = 15
BRIEF_R = 19


# --------------------------------------------------------- the ORB geometry
@functools.lru_cache(maxsize=None)
def orb_pattern() -> np.ndarray:
    """(512, 2) int pattern points (x, y); pairs are (2k, 2k+1)."""
    path = os.path.join(os.path.dirname(__file__), "data", "orb_pattern.json")
    with open(path) as f:
        return np.asarray(json.load(f), np.int64)


@functools.lru_cache(maxsize=None)
def binned_offsets() -> np.ndarray:
    """(32, 512, 2) pattern offsets rotated to each bin's centre, rounded
    half to even."""
    pat = orb_pattern().astype(np.float64)
    out = np.zeros((N_BINS, 512, 2), np.int64)
    for b in range(N_BINS):
        a = 2.0 * np.pi * b / N_BINS
        out[b, :, 0] = np.rint(pat[:, 0] * np.cos(a) - pat[:, 1] * np.sin(a))
        out[b, :, 1] = np.rint(pat[:, 0] * np.sin(a) + pat[:, 1] * np.cos(a))
    return out


@functools.lru_cache(maxsize=None)
def umax() -> np.ndarray:
    """Per-row half-width of the circular IC-angle patch (ORB's table)."""
    hp = HALF_PATCH
    um = np.zeros(hp + 2, np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        um[v] = int(np.rint(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while um[v0] == um[v0 + 1]:
            v0 += 1
        um[v] = v0
        v0 += 1
    return um[:hp + 1]


def angle_bins(angle_deg: np.ndarray) -> np.ndarray:
    return np.mod(np.rint(np.asarray(angle_deg, np.float64) * (N_BINS / 360.0)), N_BINS).astype(np.int64)


# ------------------------------------------------------------- the pyramid
def pyramid_shapes(hw, n_levels: int, scale_factor: float):
    h, w = hw
    return [(int(np.rint(h / scale_factor ** lv)), int(np.rint(w / scale_factor ** lv)))
            for lv in range(n_levels)]


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear resize, its triangle kernel widened by the
    downscale factor and each row normalised by its weight sum."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    x = (np.arange(n_out) + 0.5) * inv - 0.5
    d = np.abs(x[:, None] - np.arange(n_in)[None, :]) / ks
    wts = np.maximum(0.0, 1.0 - d)
    return wts / wts.sum(axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def blur_matrix(n: int, ksize: int = 5, sigma: float = 1.2) -> np.ndarray:
    """(n, n) 1-D Gaussian with the reflect-101 border folded in."""
    r = ksize // 2
    k = np.exp(-np.arange(-r, r + 1) ** 2 / (2.0 * sigma * sigma))
    k /= k.sum()
    B = np.zeros((n, n))
    for i in range(n):
        for t in range(-r, r + 1):
            j = i + t
            j = -j if j < 0 else (2 * (n - 1) - j if j >= n else j)
            B[i, j] += k[t + r]
    return B


def pyramid(img: np.ndarray, n_levels: int, scale_factor: float):
    """(raw levels, blurred levels rounded half to even), float64."""
    shapes = pyramid_shapes(img.shape, n_levels, scale_factor)
    raw = [img.astype(np.float64)]
    for lv in range(1, n_levels):
        p = raw[-1]
        raw.append(resize_matrix(p.shape[0], shapes[lv][0]) @ p
                   @ resize_matrix(p.shape[1], shapes[lv][1]).T)
    blur = [np.rint(blur_matrix(p.shape[0]) @ p @ blur_matrix(p.shape[1]).T) for p in raw]
    return raw, blur


def ic_angles(level: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Degrees in [0, 360) of the intensity centroid of the circular patch
    around integer keypoints xy (n, 2) of one level."""
    h, w = level.shape
    s = 2 * HALF_PATCH + 1
    u = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    uu, vv = np.meshgrid(u, u)
    inside = np.abs(uu) <= umax()[np.abs(vv)]
    x0 = np.clip(xy[:, 0] - HALF_PATCH, 0, w - s)
    y0 = np.clip(xy[:, 1] - HALF_PATCH, 0, h - s)
    win = level[(y0[:, None] + np.arange(s))[:, :, None], (x0[:, None] + np.arange(s))[:, None, :]]
    m10 = np.einsum("nij,ij->n", win, uu * inside)
    m01 = np.einsum("nij,ij->n", win, vv * inside)
    return np.mod(np.degrees(np.arctan2(m01, m10)), 360.0)


def descriptors(blurred: np.ndarray, xy: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """(n, 256) bool rBRIEF bits of integer keypoints xy in their bins."""
    h, w = blurred.shape
    S = 2 * BRIEF_R + 1
    x0 = np.clip(xy[:, 0] - BRIEF_R, 0, w - S)
    y0 = np.clip(xy[:, 1] - BRIEF_R, 0, h - S)
    off = binned_offsets()[bins]
    vals = blurred[y0[:, None] + BRIEF_R + off[..., 1], x0[:, None] + BRIEF_R + off[..., 0]]
    return vals[:, 0::2] < vals[:, 1::2]


def unpack_desc(desc: np.ndarray) -> np.ndarray:
    """(n, 8) int32 bit patterns (word w bit b = pair 32w + b) -> (n, 256) bool."""
    words = np.asarray(desc).astype(np.int64) & 0xFFFFFFFF
    return ((words[:, :, None] >> np.arange(32)) & 1).astype(bool).reshape(-1, 256)


def check_extraction(img: np.ndarray, xy: np.ndarray, octave: np.ndarray, desc: np.ndarray,
                     n_levels: int, scale_factor: float) -> dict:
    """The program's keypoints of one frame against the reference: the
    share of keypoints whose descriptor differs in any bit from the one the
    reference computes at the keypoint, in the bin of the angle the
    reference computes there."""
    raw, blur = pyramid(img, n_levels, scale_factor)
    sf = scale_factor ** np.arange(n_levels)
    n_wrong = 0
    for lv in range(n_levels):
        sel = octave == lv
        if not sel.any():
            continue
        kxy = np.rint(xy[sel] / sf[lv]).astype(np.int64)
        bits = descriptors(blur[lv], kxy, angle_bins(ic_angles(raw[lv], kxy)))
        n_wrong += int(np.sum(np.any(bits != unpack_desc(desc[sel]), axis=1)))
    n = max(int(xy.shape[0]), 1)
    return dict(desc_wrong=n_wrong / n, n=n)


# ------------------------------------------------------------ the geometry
def project(K4, Xc: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = K4
    return np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], -1)


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _exp_so3(w):
    th = np.linalg.norm(w)
    K = _hat(w)
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + math.sin(th) / th * K + (1 - math.cos(th)) / th ** 2 * K @ K


def pose_optimum(R, t, X, uv, w, K4, iters: int = 20):
    """The weighted least-squares optimum of the reprojection error over a
    fixed correspondence set, by Gauss-Newton from (R, t) (R_cw, t_cw)."""
    fx, fy = K4[0], K4[1]
    for _ in range(iters):
        Xc = X @ R.T + t
        e = uv - project(K4, Xc)
        x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        Jp = np.zeros((X.shape[0], 2, 3))
        Jp[:, 0, 0] = fx / z
        Jp[:, 0, 2] = -fx * x / z ** 2
        Jp[:, 1, 1] = fy / z
        Jp[:, 1, 2] = -fy * y / z ** 2
        dX = np.concatenate([np.broadcast_to(np.eye(3), (X.shape[0], 3, 3)),
                             -np.stack([np.stack([0 * x, -z, y], -1), np.stack([z, 0 * x, -x], -1),
                                        np.stack([-y, x, 0 * x], -1)], 1)], -1)
        J = Jp @ dX                                   # d proj / d [rho, phi]
        H = np.einsum("nik,n,nil->kl", J, w, J)
        b = np.einsum("nik,n,ni->k", J, w, e)
        dx = np.linalg.solve(H, b)
        dR = _exp_so3(dx[3:])
        R, t = dR @ R, dR @ t + dx[:3]
        if np.linalg.norm(dx) < 1e-15:
            break
    return R, t


def _left_jacobian(w):
    th = float(np.linalg.norm(w))
    K = _hat(w)
    if th < 1e-8:
        return np.eye(3) + 0.5 * K
    return np.eye(3) + (1 - math.cos(th)) / th ** 2 * K + (th - math.sin(th)) / th ** 3 * K @ K


def pose_schedule(R, t, X, uv, octave, valid, K4, scale_factor: float, rounds: int = 4,
                  its: int = 3, chi2_th: float = 5.991, min_depth: float = 1e-2):
    """ORB-SLAM3's motion-only BA (Optimizer::PoseOptimization) on a fixed
    correspondence set, with the port's schedule: `rounds` rounds of `its`
    Gauss-Newton steps from (R, t) (R_cw, t_cw), Huber at sqrt(chi2_th) in
    the first two, the edges classified by chi2 and depth after each round;
    the update Exp(dx) T with dx = [rho, phi].  Returns (R, t, inliers)."""
    fx, fy = K4[0], K4[1]
    info = scale_factor ** (-2.0 * np.asarray(octave, np.float64))
    mask = np.asarray(valid, bool).copy()
    delta = math.sqrt(chi2_th)
    for rnd in range(rounds):
        for _ in range(its):
            Xc = X @ R.T + t
            e = uv - project(K4, Xc)
            chi2 = np.sum(e * e, 1) * info
            w = info * mask
            if rnd < 2:
                r = np.sqrt(np.maximum(chi2, 1e-12))
                w = w * np.where(r <= delta, 1.0, delta / r)
            x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
            Jp = np.zeros((X.shape[0], 2, 3))
            Jp[:, 0, 0], Jp[:, 0, 2] = fx / z, -fx * x / z ** 2
            Jp[:, 1, 1], Jp[:, 1, 2] = fy / z, -fy * y / z ** 2
            J = np.concatenate([Jp, -np.einsum("nij,njk->nik", Jp, np.stack(
                [_hat(v) for v in Xc]))], -1)          # d proj / d [rho, phi]
            H = np.einsum("nik,n,nil->kl", J, w, J) + np.eye(6) * 1e-6
            dx = np.linalg.solve(H, np.einsum("nik,n,ni->k", J, w, e))
            dR = _exp_so3(dx[3:])
            R, t = dR @ R, dR @ t + _left_jacobian(dx[3:]) @ dx[:3]
            U, _, Vt = np.linalg.svd(R)
            R = U @ Vt
        Xc = X @ R.T + t
        e = uv - project(K4, Xc)
        mask = np.asarray(valid, bool) & (np.sum(e * e, 1) * info <= chi2_th) & \
            (Xc[:, 2] > min_depth)
    return R, t, mask


def check_pose_schedule(call: dict, K4, scale_factor: float) -> dict:
    """How far a tracked frame's pose-only optimization lies from the same
    schedule worked out in float64 from the same start and correspondences:
    the largest shift, in pixels, of a returned inlier's projection between
    the two poses, and the number of edges the two classify apart."""
    v = np.asarray(call["valid"], bool)
    X = np.where(v[:, None], np.asarray(call["X"], np.float64), 0.0)
    X[~v, 2] = 1.0
    uv = np.asarray(call["uv"], np.float64)
    R2, t2, inl = pose_schedule(np.asarray(call["R0"], np.float64),
                                np.asarray(call["t0"], np.float64), X, uv, call["octave"], v,
                                K4, scale_factor)
    m = np.asarray(call["inliers"], bool)
    R, t = np.asarray(call["R"], np.float64), np.asarray(call["t"], np.float64)
    shift = project(K4, X[m] @ R.T + t) - project(K4, X[m] @ R2.T + t2)
    return dict(gap_px=float(np.max(np.linalg.norm(shift, axis=1))) if m.any() else 0.0,
                flips=int(np.sum(inl != m)), n=int(m.sum()))


def check_pose(R, t, X, uv, octave, K4, scale_factor: float) -> dict:
    """How far a tracked frame's returned pose lies from the least-squares
    optimum of its own inliers: the largest shift, in pixels, of an inlier's
    projection between the two poses."""
    R, t, X, uv = (np.asarray(a, np.float64) for a in (R, t, X, uv))
    w = 1.0 / scale_factor ** (2.0 * np.asarray(octave, np.float64))
    R2, t2 = pose_optimum(R, t, X, uv, w, K4)
    shift = project(K4, X @ R.T + t) - project(K4, X @ R2.T + t2)
    return dict(gap_px=float(np.max(np.linalg.norm(shift, axis=1))))


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """(s, R, t) minimising |dst - (s R src + t)|^2 (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(b.T @ a / src.shape[0])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = np.mean(np.sum(a * a, axis=1))
    s = float(np.trace(np.diag(D) @ S) / var) if with_scale and var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def check_trajectory(est: np.ndarray, gt: np.ndarray, est_R: np.ndarray,
                     gt_R: np.ndarray) -> dict:
    """The returned camera centres against the true ones after the best
    similarity (Umeyama): RMSE as a share of the true path's span and the
    scale.  A straight path leaves that similarity's roll about the path
    free, so the map's frame is also found from the cameras' orientations
    (`est_R`, `gt_R`: camera-to-world rotations): the rotation that best
    maps the estimate's onto the truth's, with the scale and offset that
    then fit the centres best; `tilt_deg` is how far it turns the
    estimate's vertical (0 where the estimate's world is gravity-aligned)
    and `align` is (s, R, t)."""
    s, R, t = umeyama(est, gt)
    err = gt - (s * est @ R.T + t)
    span = float(np.linalg.norm(gt[-1] - gt[0])) or 1.0
    U, _, Vt = np.linalg.svd(np.einsum("nij,nkj->ik", gt_R, est_R))
    Ro = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    a, b = est - est.mean(0), gt - gt.mean(0)
    so = float(np.sum(b * (a @ Ro.T)) / max(np.sum(a * a), 1e-300))
    tilt = math.degrees(math.acos(min(1.0, max(-1.0, Ro[2, 2]))))
    return dict(ate_share=float(np.sqrt(np.mean(np.sum(err * err, 1)))) / span, scale=s,
                tilt_deg=tilt, span=span, align=(so, Ro, gt.mean(0) - so * Ro @ est.mean(0)))


def surface_height(Xw: np.ndarray, mesas) -> np.ndarray:
    """Vertical distance of world points to the scene surface under them:
    the plane z = 0 or the nearest mesa top over the point's (x, y)."""
    d = np.abs(Xw[:, 2])
    for (x0, x1, y0, y1, zm) in mesas:
        over = (Xw[:, 0] >= x0) & (Xw[:, 0] <= x1) & (Xw[:, 1] >= y0) & (Xw[:, 1] <= y1)
        d = np.where(over, np.minimum(d, np.abs(Xw[:, 2] - zm)), d)
    return d
