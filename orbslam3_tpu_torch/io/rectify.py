"""Stereo rectification from calibration (Bouguet / cv::stereoRectify).

The port's copy of `orbslam3_tpu/io/rectify.py` (importing the JAX
package's module would import JAX).  Parity target: upstream Settings builds
the rectification maps from each camera's calibration (reference
include/Settings.h:32-94, `precomputeRectificationMaps`);
`features/stereo.stereo_match` needs row-aligned pairs, which raw EuRoC
cameras are not.  Host-side numpy: the maps are computed once and applied
per frame (`io/euroc.apply_undistort`).

Distortion models: `radtan` (k1 k2 p1 p2, EuRoC) and `kb8` / equidistant
(k1..k4, TUM-VI fisheye).
"""

from __future__ import annotations

import numpy as np


def _exp_so3(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log_so3(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th * v / (2 * np.sin(th))


def _distort(x: np.ndarray, y: np.ndarray, dist, model: str):
    """Normalized ideal coords -> distorted normalized coords."""
    if model == "radtan":
        k1, k2, p1, p2 = dist
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return xd, yd
    if model in ("kb8", "equidistant"):
        k1, k2, k3, k4 = dist
        r = np.sqrt(x * x + y * y)
        th = np.arctan(r)
        th2 = th * th
        thd = th * (1 + k1 * th2 + k2 * th2 ** 2 + k3 * th2 ** 3 +
                    k4 * th2 ** 4)
        scale = np.where(r > 1e-9, thd / np.maximum(r, 1e-9), 1.0)
        return x * scale, y * scale
    raise ValueError(f"unknown distortion model {model!r}")


def stereo_rectify(K1, dist1, K2, dist2, R: np.ndarray, t: np.ndarray,
                   hw: tuple[int, int], model: str = "radtan",
                   new_hw: tuple[int, int] | None = None):
    """Bouguet stereo rectification.

    Args:
      K1/K2: (fx, fy, cx, cy) per camera.
      dist1/dist2: distortion coefficients (see `_distort`).
      R, t: relative pose cam1 -> cam2 (x2 = R @ x1 + t).
      hw: source image size.  new_hw: rectified size (default = hw).

    Returns (map1, map2, new_K4, baseline, R1, R2):
      map1/map2: (H, W, 2) float32 source (x, y) per rectified pixel, for
        euroc.apply_undistort.
      new_K4: shared rectified (fx, fy, cx, cy).
      baseline: |t| in meters (rectified pure-x offset, cam2 at +x).
      R1/R2: rectifying rotations (rectified <- camera k coords).
    """
    h, w = hw
    oh, ow = new_hw if new_hw is not None else hw
    om = _log_so3(np.asarray(R, np.float64))
    r_half = _exp_so3(-0.5 * om)            # rotate cam2 halfway toward cam1
    t_rect = r_half @ np.asarray(t, np.float64)

    # row basis aligning the baseline with +x (cv picks the dominant axis;
    # horizontal stereo assumed, like the Settings path).  e2 must come
    # from the FLIPPED e1 so e3 = e1 x e2 keeps +z forward.
    e1 = t_rect / np.linalg.norm(t_rect)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = e2 / n2 if n2 > 1e-12 else np.array([0.0, 1.0, 0.0])
    e3 = np.cross(e1, e2)
    wR = np.stack([e1, e2, e3])             # rows

    R1 = wR @ r_half.T                      # applied to cam1 coords
    R2 = wR @ r_half                        # applied to cam2 coords

    # shared rectified intrinsics: mean focal/principal point (cv refines
    # with corner projections + alpha; a valid shared P is all stereo
    # matching needs — rows align by construction)
    f = 0.5 * (K1[1] + K2[1])
    cx = 0.5 * (K1[2] + K2[2]) * ow / w
    cy = 0.5 * (K1[3] + K2[3]) * oh / h
    fs = f * min(ow / w, oh / h)
    new_K4 = (fs, fs, cx, cy)

    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    maps = []
    for K, dist, Rr in ((K1, dist1, R1), (K2, dist2, R2)):
        xr = (xs - cx) / fs
        yr = (ys - cy) / fs
        ray = np.stack([xr, yr, np.ones_like(xr)], -1) @ Rr  # = Rr^T @ ray
        xn = ray[..., 0] / ray[..., 2]
        yn = ray[..., 1] / ray[..., 2]
        xd, yd = _distort(xn, yn, dist, model)
        maps.append(np.stack([K[0] * xd + K[2], K[1] * yd + K[3]],
                             -1).astype(np.float32))
    return maps[0], maps[1], new_K4, float(np.linalg.norm(t)), R1, R2


def relative_pose_from_body(T_BS1: np.ndarray, T_BS2: np.ndarray):
    """EuRoC yaml gives T_BS (sensor -> body).  Returns (R, t) with
    x2 = R @ x1 + t (cam1 coords into cam2)."""
    T = np.linalg.inv(T_BS2) @ T_BS1
    return T[:3, :3], T[:3, 3]
