"""Synthetic textured-world renderer (pure numpy).

A copy of the functions of `orbslam3_tpu/utils/synth_render.py` that the
port's drives need: importing that module pulls in JAX through
`orbslam3_tpu/__init__.py`, and the port runs where JAX is not installed.
It renders pinhole or fisheye (`kb8_rays`) views of a textured ground plane (z = 0, camera above
looking down) by inverse mapping: pixel ray -> plane intersection ->
bilinear texture sample.  `render_plane` here defaults to no mesas, so depth is
the plane's.
"""

from __future__ import annotations

import numpy as np


def block_texture(rng: np.random.Generator, size: int = 1024,
                  block: int = 8) -> np.ndarray:
    """Multi-scale blocky random texture: sharp corners everywhere (FAST)
    with large-scale intensity variation so that local BRIEF
    neighbourhoods are distinctive."""
    out = np.zeros((size, size), np.float32)
    amp = [0.5, 0.3, 0.2]
    for lvl, b in enumerate([block, block * 4, block * 16]):
        n = -(-size // b)            # ceil division, then crop
        small = rng.uniform(0.0, 1.0, (n, n))
        big = np.kron(small, np.ones((b, b)))[:size, :size]
        out += amp[lvl] * big
    return (30.0 + 195.0 * out).astype(np.float32)


def pinhole_rays(K4, hw) -> np.ndarray:
    """(H, W, 3) camera-frame ray directions for a pinhole camera."""
    h, w = hw
    fx, fy, cx, cy = [float(v) for v in K4]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    return np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)


def kb8_rays(params, hw) -> np.ndarray:
    """(H, W, 3) camera-frame unit ray directions for a Kannala-Brandt
    fisheye (params = fx fy cx cy k1..k4): per-pixel Newton inversion of
    theta_d = theta (1 + k1 th^2 + ... + k4 th^8)."""
    h, w = hw
    fx, fy, cx, cy, k1, k2, k3, k4 = [float(v) for v in params]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    rd = np.sqrt(xd * xd + yd * yd)
    th = rd.copy()
    for _ in range(10):
        t2 = th * th
        f = th * (1 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 +
                  k4 * t2 ** 4) - rd
        df = 1 + 3 * k1 * t2 + 5 * k2 * t2 ** 2 + 7 * k3 * t2 ** 3 + \
            9 * k4 * t2 ** 4
        th = th - f / np.maximum(df, 1e-6)
    s = np.where(rd > 1e-9, np.sin(th) / np.maximum(rd, 1e-9), 1.0)
    return np.stack([xd * s, yd * s, np.cos(th)], -1).astype(np.float32)


def render_plane(R_cw: np.ndarray, t_cw: np.ndarray, K4, hw,
                 texture: np.ndarray, tex_scale: float = 100.0,
                 mesas=(), rays: np.ndarray | None = None) -> np.ndarray:
    """Render one view of the textured z=0 ground plane plus optional
    elevated textured mesas (z<0 rectangles (x0, x1, y0, y1, z)).

    R_cw/t_cw: world->camera.  tex_scale: texture pixels per world unit.
    `rays`: optional (H, W, 3) camera-frame ray directions (`kb8_rays` for
    a fisheye view); by default the pinhole rays of K4.
    Returns (H, W) float32 image in [0, 255]; rays missing all surfaces
    are 0.
    """
    Rwc = R_cw.T
    twc = -Rwc @ t_cw
    d_cam = pinhole_rays(K4, hw) if rays is None else rays
    d_w = d_cam @ Rwc.T                               # (H,W,3)
    dz = d_w[..., 2]
    dz_safe = np.where(np.abs(dz) < 1e-6, 1e-6, dz)
    # ground plane z = 0
    s = -twc[2] / dz_safe
    hit = (s > 0.1) & (np.abs(dz) > 1e-4)
    # elevated mesas (closer along the ray override the ground)
    for (x0, x1, y0, y1, zm) in (mesas or ()):
        sm = (zm - twc[2]) / dz_safe
        mx = twc[0] + sm * d_w[..., 0]
        my = twc[1] + sm * d_w[..., 1]
        on = (sm > 0.1) & (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)
        s = np.where(on & (sm < s), sm, s)
        hit |= on
    px = (twc[0] + s * d_w[..., 0]) * tex_scale
    py = (twc[1] + s * d_w[..., 1]) * tex_scale
    T = texture.shape[0]
    px = np.mod(px, T - 1.001)
    py = np.mod(py, T - 1.001)
    x0 = px.astype(np.int32)
    y0 = py.astype(np.int32)
    fx_ = px - x0
    fy_ = py - y0
    t00 = texture[y0, x0]
    t01 = texture[y0, x0 + 1]
    t10 = texture[y0 + 1, x0]
    t11 = texture[y0 + 1, x0 + 1]
    img = (t00 * (1 - fx_) + t01 * fx_) * (1 - fy_) + \
        (t10 * (1 - fx_) + t11 * fx_) * fy_
    return np.where(hit, img, 0.0).astype(np.float32)


def look_down_pose(x: float, y: float, zdist: float, yaw: float = 0.0,
                   tilt: float = 0.0):
    """Camera at (x, y, -zdist) looking at the z=0 plane (+z optical axis
    pointing toward the plane), with optional yaw about the optical axis
    and a small tilt.  Returns (R_cw, t_cw)."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    ct, st = np.cos(tilt), np.sin(tilt)
    Rx = np.array([[1.0, 0, 0], [0, ct, -st], [0, st, ct]])
    Rwc = Rz @ Rx                       # camera axes in world
    twc = np.array([x, y, -zdist])
    R_cw = Rwc.T
    t_cw = -R_cw @ twc
    return R_cw.astype(np.float32), t_cw.astype(np.float32)
