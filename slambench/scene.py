"""The benchmark's sequences: camera paths, IMU samples and rendered frames.

A sequence is drawn from a traffic file (`traffic/<name>.json`) and the
run's seed.  The path is fixed by the file; the seed draws the texture, the
pixel noise and the IMU's noise and bias walk, so that every seed asks the
System for the same amount of work.

The renderer is a PyTorch copy of the numpy ray-caster the port's tests and
drives use (`block_texture`, `render_plane` with the default mesas,
its look-down pose): a pinhole camera above a textured ground plane z = 0 with
textured mesas (z < 0 rectangles) toward it.  It renders on the device in
batches, because the numpy version takes ~150 ms a frame on a CPU core.
`render_plane_np` is the numpy version as it was frozen here; the harness's
tests hold the two against each other.

Each path coordinate is `c + v t + g tau (1 - exp(-t / tau)) + sum_i a_i
sin(w_i t + p_i)` (`glide: [g, tau]`: a speed g at the start that decays
smoothly), for x, y, the height above the plane and the camera's yaw and
tilt.  The IMU reads the path's derivatives at each 200 Hz
sample's midpoint, as the port's chain ablation drive computes them (central
differences of the pose), in the body frame given by the configuration's
`Tbc`, with white noise and a bias random walk at the configuration's
densities.
"""

from __future__ import annotations

import math

import numpy as np
import torch

G_W = np.array([0.0, 0.0, -9.81])


# ------------------------------------------------------------------ the path
def _coord(spec: dict, t: float) -> float:
    g, tau = spec.get("glide", (0.0, 1.0))
    out = spec.get("c", 0.0) + spec.get("v", 0.0) * t + g * tau * (1.0 - math.exp(-t / tau))
    for a, w, p in spec.get("sin", ()):
        out += a * math.sin(w * t + p)
    return out


class Path:
    """The camera path of a traffic file's `path` block."""

    def __init__(self, spec: dict):
        self.spec = spec

    def pose64(self, t: float):
        """(Rwc, pwc) in float64: the camera at (x, y, -height) looking at
        the z = 0 plane (+z optical axis toward it), turned by the yaw about
        the optical axis and then the tilt."""
        s = self.spec
        x, y, h = (_coord(s[k], t) for k in ("x", "y", "height"))
        yaw, tilt = (_coord(s.get(k, {}), t) for k in ("yaw", "tilt"))
        cz, sz = np.cos(yaw), np.sin(yaw)
        ct, st = np.cos(tilt), np.sin(tilt)
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
        Rx = np.array([[1.0, 0, 0], [0, ct, -st], [0, st, ct]])
        return Rz @ Rx, np.array([x, y, -h])

    def pose_cw(self, t: float):
        """(R_cw, t_cw) in float32, as the renderer takes them."""
        Rwc, pwc = self.pose64(t)
        return Rwc.T.astype(np.float32), (-Rwc.T @ pwc).astype(np.float32)

    def center(self, t: float) -> np.ndarray:
        return self.pose64(t)[1]


# ------------------------------------------------------------------- the IMU
def imu_samples(path: Path, Tbc: np.ndarray, rate: float, fps: float, n_frames: int,
                noise: dict, rng: np.random.Generator):
    """Per frame i, the samples (t, gyro, acc) of ((i-1)/fps, i/fps], each
    read at its interval's midpoint (the port's ablation drive's scheme), in
    the body frame of `Tbc` (body <- camera), with white noise and a bias
    walk at the densities of `noise` (`noise_gyro`, `noise_acc`, `walk_gyro`,
    `walk_acc`, continuous time)."""
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    Rcb = Rbc.T
    tcb = -Rcb @ tbc
    dt = 1.0 / rate
    h = 1e-3

    def body(t):
        Rwc, pwc = path.pose64(t)
        return Rwc @ Rcb, pwc + Rwc @ tcb

    def read(t):
        a_w = (body(t + h)[1] - 2.0 * body(t)[1] + body(t - h)[1]) / (h * h)
        R0, R1 = body(t)[0], body(t + h)[0]
        dR = R0.T @ R1
        w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) * 0.5 / h
        return w, R0.T @ (a_w - G_W)

    per_frame = [[] for _ in range(n_frames)]
    n_total = int(round((n_frames - 1) / fps * rate))
    sig_w = noise["noise_gyro"] / math.sqrt(dt)
    sig_a = noise["noise_acc"] / math.sqrt(dt)
    walk = np.array([noise["walk_gyro"]] * 3 + [noise["walk_acc"]] * 3) * math.sqrt(dt)
    white = rng.standard_normal((n_total, 6))
    steps = rng.standard_normal((n_total, 6)) * walk
    bias = np.cumsum(steps, axis=0)
    for k in range(n_total):
        # (k + 1) / rate, so that a sample at a frame's time equals the
        # frame's timestamp (i / fps) to the bit
        tm = (k + 1) / rate
        w, a = read(tm - 0.5 * dt)
        g = w + bias[k, :3] + sig_w * white[k, :3]
        f = a + bias[k, 3:] + sig_a * white[k, 3:]
        i = min(int(math.ceil(tm * fps - 1e-9)), n_frames - 1)
        per_frame[i].append((tm, g.astype(np.float32), f.astype(np.float32)))
    return per_frame


# ------------------------------------------------------------- the renderer
def default_mesas(rng: np.random.Generator, n: int = 24, area: float = 10.0) -> tuple:
    """Random elevated rectangles (x0, x1, y0, y1, z) toward the camera."""
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


def block_texture(gen: torch.Generator, size: int = 1024, block: int = 8,
                  device="cpu") -> torch.Tensor:
    """Multi-scale blocky random texture in [30, 225] (float32), drawn from
    `gen` on `device` in three calls."""
    out = torch.zeros((size, size), dtype=torch.float32, device=device)
    for amp, b in ((0.5, block), (0.3, block * 4), (0.2, block * 16)):
        n = -(-size // b)
        small = torch.rand((n, n), generator=gen, dtype=torch.float64, device=device)
        big = small.repeat_interleave(b, 0).repeat_interleave(b, 1)[:size, :size]
        out += (amp * big).to(torch.float32)
    return 30.0 + 195.0 * out


def pinhole_rays(K4, hw, device="cpu") -> torch.Tensor:
    h, w = hw
    fx, fy, cx, cy = (float(v) for v in K4)
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)


def render_batch(R_cw: torch.Tensor, t_cw: torch.Tensor, rays: torch.Tensor,
                 texture: torch.Tensor, tex_scale: float, mesas=DEFAULT_MESAS) -> torch.Tensor:
    """(B, H, W) float32 views of the plane and mesas for B poses (B, 3, 3)
    and (B, 3): the batched form of `render_plane_np`."""
    Rwc = R_cw.transpose(1, 2)
    twc = -torch.einsum("bij,bj->bi", Rwc, t_cw)
    d_w = torch.einsum("hwk,bjk->bhwj", rays, Rwc)
    dz = d_w[..., 2]
    dz_safe = torch.where(dz.abs() < 1e-6, torch.full_like(dz, 1e-6), dz)
    tz = twc[:, 2, None, None]
    s = -tz / dz_safe
    hit = (s > 0.1) & (dz.abs() > 1e-4)
    tx, ty = twc[:, 0, None, None], twc[:, 1, None, None]
    for (x0, x1, y0, y1, zm) in mesas:
        sm = (zm - tz) / dz_safe
        mx = tx + sm * d_w[..., 0]
        my = ty + sm * d_w[..., 1]
        on = (sm > 0.1) & (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)
        s = torch.where(on & (sm < s), sm, s)
        hit |= on
    T = texture.shape[0]
    px = torch.remainder((tx + s * d_w[..., 0]) * tex_scale, T - 1.001)
    py = torch.remainder((ty + s * d_w[..., 1]) * tex_scale, T - 1.001)
    x0 = px.to(torch.int64)
    y0 = py.to(torch.int64)
    fx_ = px - x0
    fy_ = py - y0
    flat = texture.reshape(-1)
    t00, t01 = flat[y0 * T + x0], flat[y0 * T + x0 + 1]
    t10, t11 = flat[(y0 + 1) * T + x0], flat[(y0 + 1) * T + x0 + 1]
    img = (t00 * (1 - fx_) + t01 * fx_) * (1 - fy_) + (t10 * (1 - fx_) + t11 * fx_) * fy_
    return torch.where(hit, img, torch.zeros_like(img))


def render_plane_np(R_cw, t_cw, K4, hw, texture: np.ndarray, tex_scale: float = 100.0,
                    mesas=DEFAULT_MESAS) -> np.ndarray:
    """The numpy ray-caster, frozen: one (H, W) float32 view."""
    h, w = hw
    fx, fy, cx, cy = [float(v) for v in K4]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    Rwc = R_cw.T
    twc = -Rwc @ t_cw
    d_w = d_cam @ Rwc.T
    dz = d_w[..., 2]
    dz_safe = np.where(np.abs(dz) < 1e-6, 1e-6, dz)
    s = -twc[2] / dz_safe
    hit = (s > 0.1) & (np.abs(dz) > 1e-4)
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
    img = (texture[y0, x0] * (1 - fx_) + texture[y0, x0 + 1] * fx_) * (1 - fy_) + \
        (texture[y0 + 1, x0] * (1 - fx_) + texture[y0 + 1, x0 + 1] * fx_) * fy_
    return np.where(hit, img, 0.0).astype(np.float32)


# -------------------------------------------------------------- a sequence
class Sequence:
    """A traffic file's sequence for one seed: `frames` (n, H, W) uint8 in
    host memory, `ts` their timestamps, `centers` the true camera centres,
    and with an IMU `imu[i]` the samples of frame i's interval."""

    def __init__(self, traffic: dict, cam: dict, seed: int, device, imu_noise=None,
                 Tbc=None, batch: int = 32):
        self.traffic = traffic
        self.path = Path(traffic["path"])
        fps = float(traffic["camera_hz"])
        n = int(traffic["frames"])
        self.fps, self.n = fps, n
        self.ts = [i / fps for i in range(n)]
        self.centers = np.stack([self.path.center(t) for t in self.ts])
        hw = tuple(cam["image_hw"])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (2 ** 63))
        tex = traffic["texture"]
        texture = block_texture(gen, tex["size"], tex["block"], device)
        rays = pinhole_rays(cam["cam_params"], hw, device)
        frames = torch.empty((n, *hw), dtype=torch.uint8)
        sigma = float(traffic["pixel_noise"])
        for b0 in range(0, n, batch):
            poses = [self.path.pose_cw(t) for t in self.ts[b0:b0 + batch]]
            R = torch.from_numpy(np.stack([p[0] for p in poses])).to(device)
            t = torch.from_numpy(np.stack([p[1] for p in poses])).to(device)
            img = render_batch(R, t, rays, texture, float(tex["tex_scale"]))
            img = img + sigma * torch.randn(img.shape, generator=gen, device=device)
            frames[b0:b0 + batch] = img.clamp_(0, 255).to(torch.uint8).cpu()
        self.frames = frames.numpy()
        self.imu = None
        if imu_noise is not None:
            rng = np.random.default_rng(int(seed) % (2 ** 63))
            self.imu = imu_samples(
                self.path, np.asarray(Tbc, np.float64).reshape(4, 4),
                float(traffic["imu_hz"]), fps, n, imu_noise, rng)
