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
* the height of the map's new points above the true scene surface;
* the rectified stereo association of each sampled pair (`stereo_association`,
  `refine_right_u`), from the two images the benchmark rendered and the
  keypoints the program extracted from them.
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


# ------------------------------------------------------ the stereo association
TH_HIGH = 100          # ORBmatcher::TH_HIGH
STEREO_NN_RATIO = (9, 10)


def stereo_gates(baseline: float, max_depth_factor: float, scale_factor: float) -> dict:
    """The association's settings for a configuration: the row band of
    2 px at octave 0 (Frame::ComputeStereoMatches' 2 * scale factor^octave),
    depths from 0.1 m to three times the close-point horizon
    (max_depth_factor baselines, the stereo Systems' far gate), the
    (2 * 5 + 1)^2 patch of ComputeStereoMatches and the sweep of +-2 px that
    the port's `features/stereo.py` documents."""
    return dict(row_tol=2.0, min_depth=0.1, max_depth=float(max_depth_factor) * baseline * 3,
                scale_factor=float(scale_factor), w=5, r_search=2)


def hamming(desc_a: np.ndarray, desc_b: np.ndarray, block: int = 256) -> np.ndarray:
    """(n, m) Hamming distances of (n, 8) and (m, 8) int32 bit patterns: the
    popcount of their XOR, byte by byte."""
    pop = np.array([bin(v).count("1") for v in range(256)], np.int64)
    a = np.ascontiguousarray(desc_a, np.int32).view(np.uint8)
    b = np.ascontiguousarray(desc_b, np.int32).view(np.uint8)
    out = np.empty((a.shape[0], b.shape[0]), np.int64)
    for r in range(0, a.shape[0], block):
        out[r:r + block] = pop[a[r:r + block, None, :] ^ b[None, :, :]].sum(-1)
    return out


def stereo_association(xy_l, oct_l, desc_l, xy_r, oct_r, desc_r, fx: float, baseline: float,
                       row_tol: float, min_depth: float, max_depth: float,
                       scale_factor: float) -> dict:
    """The association of a rectified pair's keypoints (ORB-SLAM3's
    Frame::ComputeStereoMatches candidate search, with the port's documented
    gates, `features/stereo.py`): a right keypoint is a candidate for a left
    one on the same row within row_tol * scale_factor^octave, at a
    disparity that [min_depth, max_depth] allows, and at most one octave
    apart; the nearest candidate by Hamming distance is kept when it is at
    most TH_HIGH and under 0.9 of the second nearest (in integers: 10 best <
    9 second); a right keypoint claimed by several left ones goes to the one
    with the lowest (distance, index); the depth fx b / d must lie inside
    the range.

    The gates compare the float32 coordinates in float32, the precision the
    configuration states: keypoints above octave 0 sit on their level's
    grid, so many pairs lie on a row band's very edge (two octave-1
    keypoints two of their rows apart are 2 * 1.2 px apart, as wide as the
    band), where the coordinates' rounding decides, and float64 would
    decide some of them otherwise.  Returns per left keypoint `j` (the right keypoint, -1 if none), `valid`
    and `ur` (the right keypoint's u, -1 if none)."""
    f32 = np.float32
    xy_l, xy_r = np.asarray(xy_l, f32), np.asarray(xy_r, f32)
    oct_l, oct_r = np.asarray(oct_l, np.int64), np.asarray(oct_r, np.int64)
    n, m = xy_l.shape[0], xy_r.shape[0]
    if m == 0:
        return dict(j=np.full(n, -1, np.int64), valid=np.zeros(n, bool), ur=np.full(n, -1.0))
    fb = f32(fx * baseline)
    du = xy_l[:, None, 0] - xy_r[None, :, 0]
    dv = np.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    tol = f32(row_tol) * np.power(f32(scale_factor), oct_l.astype(f32))
    mask = (dv <= tol[:, None]) & (du >= f32(fx * baseline / max_depth)) & \
        (du <= f32(fx * baseline / min_depth))
    mask &= np.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    big = 1 << 20                     # no candidate: above any distance
    d = np.where(mask, hamming(desc_l, desc_r), big)
    rows = np.arange(n)
    best_j = np.argmin(d, axis=1)
    best = d[rows, best_j]
    d2 = d.copy()
    d2[rows, best_j] = big
    second = d2.min(axis=1)
    num, den = STEREO_NN_RATIO
    ok = (best <= TH_HIGH) & (den * best < num * second)
    # a right keypoint claimed twice goes to the lowest (distance, left index)
    order = np.lexsort((rows, best))
    taken = np.zeros(m, bool)
    for i in order[ok[order]]:
        if taken[best_j[i]]:
            ok[i] = False
        taken[best_j[i]] = True
    ur = xy_r[best_j, 0]
    depth = fb / np.maximum(xy_l[:, 0] - ur, f32(1e-3))
    ok &= (depth > f32(min_depth)) & (depth < f32(max_depth))
    return dict(j=np.where(ok, best_j, -1), valid=ok, ur=np.where(ok, ur.astype(np.float64), -1.0))


def refine_right_u(img_l: np.ndarray, img_r: np.ndarray, xy_l, ur, valid, w: int = 5,
                   r_search: int = 2) -> np.ndarray:
    """The subpixel right u of each associated left keypoint (the sweep and
    parabola of ORB-SLAM3's Frame::ComputeStereoMatches, with the port's
    documented SSD): the (2w+1)^2 patch around the rounded left keypoint
    against the right image's patches on the same rows, shifted over
    [-r_search, r_search] around the rounded matched u; the SSD per shift in
    integers, the first of tied minima, a parabola through the minimum and
    its neighbours.  A minimum on the sweep's edge, or a vertex that moved
    more than r_search + 1, keeps the matched u.  -1 where not associated."""
    L = np.asarray(img_l, np.int64)
    Rt = np.asarray(img_r, np.int64)
    h, wid = L.shape
    s, sw = 2 * w + 1, 2 * w + 1 + 2 * r_search
    xy_l = np.asarray(xy_l, np.float64)
    ur = np.asarray(ur, np.float64)
    out = np.where(valid, ur, -1.0)
    for i in np.flatnonzero(valid):
        y = int(np.clip(np.rint(xy_l[i, 1]) - w, 0, h - s))
        xl0 = int(np.clip(np.rint(xy_l[i, 0]) - w, 0, wid - s))
        xr0 = int(np.clip(np.rint(ur[i]) - w - r_search, 0, wid - sw))
        Pl = L[y:y + s, xl0:xl0 + s]
        Pr = Rt[y:y + s, xr0:xr0 + sw]
        ssd = np.array([np.sum((Pr[:, k:k + s] - Pl) ** 2) for k in range(2 * r_search + 1)])
        best = int(np.argmin(ssd))
        bc = min(max(best, 1), 2 * r_search - 1)
        if best != bc:
            continue
        c0, c1, c2 = (float(ssd[bc + k]) for k in (-1, 0, 1))
        denom = c0 + c2 - 2.0 * c1
        frac = min(max(0.5 * (c0 - c2) / denom, -1.0), 1.0) if abs(denom) > 1e-6 else 0.0
        u = xr0 + bc + frac + w
        if abs(u - ur[i]) <= r_search + 1.0:
            out[i] = u
    return out


def check_stereo(pair: dict, img_l: np.ndarray, img_r: np.ndarray, fx: float,
                 baseline: float, gates: dict) -> dict:
    """A sampled pair's association and refinement against the reference's,
    over the pair's valid left keypoints: `wrong`, the share whose validity,
    matched right keypoint (its u as matched) or refined right u (beyond
    1e-3 px; -1 on both sides where not associated) differs; and, over the
    keypoints both associate alike, the largest gap of the refined right u
    (px) and of the depth relative to fx b / (u_l - u_r) in float64.
    `gates`: `stereo_gates`' settings."""
    p = gates
    ref = stereo_association(pair["xy_l"], pair["oct_l"], pair["desc_l"], pair["xy_r"],
                             pair["oct_r"], pair["desc_r"], fx, baseline, p["row_tol"],
                             p["min_depth"], p["max_depth"], p["scale_factor"])
    ur = refine_right_u(img_l, img_r, pair["xy_l"], ref["ur"], ref["valid"], p["w"],
                        p["r_search"])
    got_valid = np.asarray(pair["valid"], bool)
    got_ur = np.where(got_valid, np.asarray(pair["ur"], np.float64), -1.0)
    same = (got_valid == ref["valid"]) & \
        (np.where(got_valid, np.asarray(pair["ur_matched"], np.float64), -1.0) == ref["ur"])
    gap = np.abs(got_ur - ur)
    wrong = ~same | (gap > 1e-3)
    both = same & ref["valid"]
    n = max(int(got_valid.shape[0]), 1)
    depth = fx * baseline / np.maximum(np.asarray(pair["xy_l"], np.float64)[:, 0] - ur, 1e-3)
    rel = np.abs(np.asarray(pair["depth"], np.float64) - depth) / depth
    return dict(wrong=float(np.sum(wrong)) / n, n=n, n_assoc=int(np.sum(ref["valid"])),
                ur_gap_px=float(np.max(gap[both])) if both.any() else 0.0,
                depth_rel_gap=float(np.max(rel[both])) if both.any() else 0.0)
