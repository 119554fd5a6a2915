"""Synthetic feature worlds for the drives that feed features, not images.

The port's own copy of the JAX test fixtures that `drive_vi_gnss` and
`drive_kf_times` import: `K4`, `HW`, `N_KP`, `SyntheticWorld` and
`camera_path` from `tests/test_pipeline_e2e.py:16-73`, and `G`, `FPS`,
`IMU_HZ` and `camera_path_smooth` from `tests/test_inertial_pipeline.py:12-67`.
Those modules import JAX, so the port cannot import them.

A camera flies through a random landmark field; each frame's
`FeatureFrame` comes from projecting the landmarks (a stable descriptor per
landmark with a few bits flipped, pixel noise, per-frame dropout).
`SyntheticWorld` makes the same NumPy calls in the same order as the
fixture, so a world with the same seed gives the same frames bit for bit;
the descriptors are int32 bit patterns (torch has no uint32 shift on the
CPU).  `camera_path` turns its yaw into a rotation with the port's
`ops/lie.exp_so3` in float32 on the CPU, where the fixture calls JAX's.
NumPy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.extractor import FeatureFrame
from ..ops import lie

K4 = (458.654, 457.296, 367.215, 248.375)
HW = (480, 752)
N_KP = 512  # feature capacity per synthetic frame

G = np.array([0.0, 0.0, -9.81])
FPS = 20.0
IMU_HZ = 200.0


class SyntheticWorld:
    def __init__(self, seed=0, n_landmarks=3000):
        rng = np.random.default_rng(seed)
        # landmark field in a corridor along +x
        self.X = np.stack([
            rng.uniform(-2, 22, n_landmarks),
            rng.uniform(-4, 4, n_landmarks),
            rng.uniform(2.0, 10.0, n_landmarks)], axis=1).astype(np.float32)
        self.desc = rng.integers(0, 2 ** 32, (n_landmarks, 8), dtype=np.uint32)
        self.rng = rng

    def frame(self, R_cw, t_cw, noise_px=0.4, dropout=0.15, flip_bits=4,
              device="cpu") -> FeatureFrame:
        Xc = self.X @ np.asarray(R_cw).T + np.asarray(t_cw)
        z = Xc[:, 2]
        uv = np.stack([K4[0] * Xc[:, 0] / np.maximum(z, 1e-6) + K4[2],
                       K4[1] * Xc[:, 1] / np.maximum(z, 1e-6) + K4[3]], 1)
        vis = (z > 0.3) & (uv[:, 0] > 10) & (uv[:, 0] < HW[1] - 10) & \
              (uv[:, 1] > 10) & (uv[:, 1] < HW[0] - 10)
        vis &= self.rng.random(len(z)) > dropout
        idx = np.nonzero(vis)[0]
        self.rng.shuffle(idx)
        idx = idx[:N_KP]
        n = len(idx)
        xy = uv[idx] + noise_px * self.rng.standard_normal((n, 2))
        desc = self.desc[idx].copy()
        # flip a few bits to emulate descriptor noise
        for _ in range(flip_bits):
            w = self.rng.integers(0, 8, n)
            b = self.rng.integers(0, 32, n)
            desc[np.arange(n), w] ^= (np.uint32(1) << b.astype(np.uint32))
        pad = N_KP - n
        xy = np.concatenate([xy, np.zeros((pad, 2))]).astype(np.float32)
        desc = np.concatenate([desc, np.zeros((pad, 8), np.uint32)]).view(np.int32)
        on = lambda a: torch.from_numpy(a).to(device)
        return FeatureFrame(
            xy=on(xy), response=torch.ones(N_KP, device=device),
            octave=torch.zeros(N_KP, dtype=torch.int32, device=device),
            angle=torch.zeros(N_KP, device=device), desc=on(desc),
            valid=on(np.arange(N_KP) < n))


def camera_path(n_frames, speed=0.06):
    """Forward motion with gentle yaw: world-to-camera poses."""
    poses = []
    for i in range(n_frames):
        yaw = 0.1 * np.sin(i * 0.05)
        Rwc = lie.exp_so3(torch.tensor([0.0, yaw, 0.0], dtype=torch.float32)).numpy()
        twc = np.array([speed * i, 0.3 * np.sin(i * 0.08), 0.0])
        R_cw = Rwc.T
        t_cw = -R_cw @ twc
        poses.append((R_cw.astype(np.float32), t_cw.astype(np.float32), twc))
    return poses


def camera_path_smooth(n_frames):
    """Twc trajectory with real acceleration (for scale observability).
    Returns the list of (R_cw, t_cw, twc, Rwc) plus analytic pos / vel / acc,
    rot and rot_rate."""
    dt = 1.0 / FPS

    def pos(t):
        return np.array([1.2 * np.sin(0.8 * t) + 0.6 * t,
                         0.8 * np.sin(1.1 * t + 1.0),
                         0.4 * np.sin(0.9 * t)])

    def vel(t):
        return np.array([1.2 * 0.8 * np.cos(0.8 * t) + 0.6,
                         0.8 * 1.1 * np.cos(1.1 * t + 1.0),
                         0.4 * 0.9 * np.cos(0.9 * t)])

    def acc(t):
        return np.array([-1.2 * 0.64 * np.sin(0.8 * t),
                         -0.8 * 1.21 * np.sin(1.1 * t + 1.0),
                         -0.4 * 0.81 * np.sin(0.9 * t)])

    def _rodrigues(w):
        """NumPy SO3 exp."""
        th = np.linalg.norm(w)
        if th < 1e-10:
            return np.eye(3)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    def rot(t):  # gentle yaw
        return _rodrigues(np.array([0.0, 0.12 * np.sin(0.3 * t), 0.05 * t]))

    def rot_rate(t, eps=1e-4):
        R0, R1 = rot(t), rot(t + eps)
        dR = R0.T @ R1
        w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                      dR[1, 0] - dR[0, 1]]) * 0.5
        return w / eps

    frames = []
    for i in range(n_frames):
        t = i * dt
        Rwc = rot(t)
        twc = pos(t)
        R_cw = Rwc.T
        frames.append((R_cw.astype(np.float32),
                       (-R_cw @ twc).astype(np.float32), twc, Rwc))
    return frames, pos, vel, acc, rot, rot_rate


def imu_between(t0: float, t1: float, rot, acc, rot_rate):
    """The 200 Hz samples (tm, gyro, acc) of (t0, t1], each read at its
    interval's midpoint, as the drives feed `grab_imu`."""
    dt_i = 1.0 / IMU_HZ
    out = []
    k = 1
    while t0 + k * dt_i <= t1 + 1e-9:
        tm = t0 + k * dt_i
        Rb = rot(tm - 0.5 * dt_i)
        out.append((tm, rot_rate(tm - 0.5 * dt_i), Rb.T @ (acc(tm - 0.5 * dt_i) - G)))
        k += 1
    return out
