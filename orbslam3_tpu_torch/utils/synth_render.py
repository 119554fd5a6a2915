"""Synthetic textured-world renderer (pure numpy).

A copy of `orbslam3_tpu/utils/synth_render.py`: importing that module pulls
in JAX through `orbslam3_tpu/__init__.py`, and the port runs where JAX is
not installed.  It renders pinhole or fisheye (`kb8_rays`) views of a
textured ground plane (z = 0, camera above looking down) by inverse
mapping: pixel ray -> plane intersection -> bilinear texture sample; four
texture families, the elevated mesas (`default_mesas`) and a photometric
stress model (`photometric_stress`).  `render_plane` draws the JAX
package's default mesas (`DEFAULT_MESAS`) unless told otherwise, as the JAX
copy does; a scene whose depth must be the plane's passes `mesas=()`.
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


def voronoi_texture(rng: np.random.Generator, size: int = 1024,
                    n_seeds: int = 500) -> np.ndarray:
    """Voronoi-cell texture: random polygonal cells with per-cell
    intensity + a fine speckle layer.  A texture FAMILY disjoint from
    block_texture (irregular oblique edges and junctions vs axis-aligned
    multi-scale blocks) — used to test vocabulary/extractor
    generalization beyond the statistics they were trained on."""
    pts = rng.uniform(0, size, (n_seeds, 2)).astype(np.float32)
    vals = rng.uniform(0.0, 1.0, n_seeds).astype(np.float32)
    out = np.zeros((size, size), np.float32)
    xs = np.arange(size, dtype=np.float32)
    for r0 in range(0, size, 128):           # row tiles bound memory
        yy = np.arange(r0, r0 + 128, dtype=np.float32)[:, None, None]
        xx = xs[None, :, None]
        d2 = (xx - pts[None, None, :, 0]) ** 2 + \
             (yy - pts[None, None, :, 1]) ** 2
        out[r0:r0 + 128] = vals[np.argmin(d2, axis=-1)]
    speck = rng.uniform(-0.08, 0.08, (size, size)).astype(np.float32)
    return np.clip(30.0 + 195.0 * (out + speck), 0, 255).astype(np.float32)


def stripe_texture(rng: np.random.Generator, size: int = 1024,
                   n_orient: int = 4) -> np.ndarray:
    """Superposed oriented gratings, thresholded: long oblique edges and
    X-junctions with strong orientation statistics — a texture family
    disjoint from both block (axis-aligned) and voronoi (isotropic
    cells).  Exercises the vocabulary on edge-dominated descriptors."""
    u, v = np.meshgrid(np.arange(size, dtype=np.float32),
                       np.arange(size, dtype=np.float32))
    acc = np.zeros((size, size), np.float32)
    for _ in range(n_orient):
        th = rng.uniform(0, np.pi)
        f = rng.uniform(0.02, 0.10)
        acc += np.sin(2 * np.pi * f * (u * np.cos(th) + v * np.sin(th)) +
                      rng.uniform(0, 6.28)).astype(np.float32)
    lvl = np.digitize(acc, np.quantile(acc, [0.25, 0.5, 0.75]))
    speck = rng.uniform(-0.06, 0.06, (size, size)).astype(np.float32)
    return np.clip(30.0 + 195.0 * (lvl / 3.0 + speck), 0,
                   255).astype(np.float32)


def blob_texture(rng: np.random.Generator, size: int = 1024,
                 n_blobs: int = 350) -> np.ndarray:
    """Soft Gaussian blobs over a mid-gray field: curved boundaries and
    low-contrast gradients (the hardest regime for FAST/BRIEF) — a
    fourth texture family for place-recognition stress."""
    out = np.full((size, size), 0.5, np.float32)
    ys = rng.uniform(0, size, n_blobs)
    xs_ = rng.uniform(0, size, n_blobs)
    sig = rng.uniform(6, 40, n_blobs)
    amp = rng.uniform(-0.5, 0.5, n_blobs)
    grid = np.arange(size, dtype=np.float32)
    for i in range(n_blobs):
        r = int(3 * sig[i])
        y0, x0 = int(ys[i]), int(xs_[i])
        ys_l = slice(max(y0 - r, 0), min(y0 + r, size))
        xs_l = slice(max(x0 - r, 0), min(x0 + r, size))
        gy = np.exp(-0.5 * ((grid[ys_l] - ys[i]) / sig[i]) ** 2)
        gx = np.exp(-0.5 * ((grid[xs_l] - xs_[i]) / sig[i]) ** 2)
        out[ys_l, xs_l] += amp[i] * gy[:, None] * gx[None, :]
    speck = rng.uniform(-0.05, 0.05, (size, size)).astype(np.float32)
    return np.clip(30.0 + 195.0 * np.clip(out + speck, 0, 1), 0,
                   255).astype(np.float32)


def default_mesas(rng: np.random.Generator, n: int = 24,
                  area: float = 10.0) -> tuple:
    """Random elevated textured rectangles toward the camera (negative z).
    The scene must be substantially NON-planar or two-view init hits the
    homography twin-solution ambiguity (exactly like the reference on
    planar scenes)."""
    out = []
    for _ in range(n):
        x0 = rng.uniform(-2, area)
        y0 = rng.uniform(-2, area)
        w = rng.uniform(0.6, 1.6)
        h = rng.uniform(0.6, 1.6)
        z = -rng.uniform(0.8, 2.2)
        out.append((x0, x0 + w, y0, y0 + h, z))
    return tuple(out)


DEFAULT_MESAS = default_mesas(np.random.default_rng(99))


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
                 mesas=DEFAULT_MESAS, rays: np.ndarray | None = None) -> np.ndarray:
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


def photometric_stress(img: np.ndarray, exposure: float = 1.0,
                       gamma: float = 1.0, vignette: float = 0.0,
                       blur_px: float = 0.0, blur_dir=(1.0, 0.0),
                       noise: float = 0.0,
                       rng: np.random.Generator | None = None
                       ) -> np.ndarray:
    """Photometric stress model for hostile synthetic drives (stands in
    for the EuRoC/TUM-VI photometric regimes: auto-exposure steps, gamma
    differences, lens vignetting, motion blur, sensor noise).

    exposure: multiplicative gain.  gamma: (img/255)**gamma curve.
    vignette: 0..1 corner attenuation (cos^4-style radial falloff).
    blur_px: linear motion-blur length in pixels along blur_dir.
    noise: additive Gaussian sigma (greylevels).  Returns [0,255] f32.
    """
    out = img.astype(np.float32)
    if gamma != 1.0:
        out = 255.0 * np.power(np.clip(out, 0, 255) / 255.0, gamma)
    if exposure != 1.0:
        out = out * exposure
    if vignette > 0.0:
        h, w = out.shape
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        r2 = (((xx - w / 2) / (w / 2)) ** 2 +
              ((yy - h / 2) / (h / 2)) ** 2) / 2.0
        out = out * (1.0 - vignette * r2 ** 2)
    if blur_px >= 1.0:
        n = int(np.ceil(blur_px))
        dx, dy = blur_dir
        nrm = max(np.hypot(dx, dy), 1e-9)
        dx, dy = dx / nrm, dy / nrm
        acc = np.zeros_like(out)
        for k in range(n):
            off = (k - (n - 1) / 2.0) * blur_px / max(n, 1)
            sx, sy = int(round(off * dx)), int(round(off * dy))
            acc += np.roll(np.roll(out, sy, axis=0), sx, axis=1)
        out = acc / n
    if noise > 0.0 and rng is not None:
        out = out + rng.normal(0.0, noise, out.shape)
    return np.clip(out, 0.0, 255.0).astype(np.float32)


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
