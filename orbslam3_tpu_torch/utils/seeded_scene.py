"""A seeded-map monocular drive of the per-frame step, with ground truth.

The scene is `bench.py`'s (`bench_full_system`, bench.py:99-119): a
textured ground plane seen from 5 units above along a gently weaving
trajectory (frame i at t = i/10), rendered with sensor noise of sigma 1.5.
Mesas are left out so that every pixel's depth is the plane's, which lets
the map be seeded without two-view initialization (not ported yet):

  * each seed keyframe is extracted, its valid keypoints back-projected
    onto z = 0 with the ground-truth pose and appended with
    `add_keyframe` / `add_points` (`point_descriptor_stats` for normal
    and scale range);
  * every seeded point is observed (`add_observations`) in every seed
    keyframe where it projects inside the image;
  * the local view is `gather_local_view` around the last seed keyframe;
  * the tracked frames then run `frame_step.track_frame`, starting from
    the ground-truth velocity, and each tracked pose is held against the
    ground truth.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..features.extractor import OrbParams, extract
from ..ops import cameras, lie
from ..pipeline import frame_step, mapping
from ..slam_map import state as mapstate
from . import synth_render as sr


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Defaults: the JAX package's default monocular configuration
    (`SlamConfig()`, orbslam3_tpu/pipeline/system.py:52-77) on bench.py's
    camera."""
    hw: tuple = (480, 752)
    K4: tuple = (400.0, 400.0, 376.0, 240.0)
    orb: OrbParams = OrbParams()
    capacity: mapstate.MapCapacity = mapstate.MapCapacity()
    seed_frames: tuple = (0, 6, 12, 18)
    track_frames: tuple = tuple(range(19, 43))
    view_points: int = 8192
    view_kfs: int = 12
    radius_th: float = 4.0
    tex_block: int = 10
    tex_scale: float = 60.0
    noise_sigma: float = 1.5
    seed: int = 3
    # gates on every tracked frame: SlamConfig.min_track_inliers, and the
    # pose against ground truth (camera centre in world units, rotation)
    min_inliers: int = 30
    max_center_err: float = 0.05
    max_rot_err_deg: float = 0.5


def bench_pose(i: int):
    """Ground-truth (R_cw, t_cw) of frame i (bench.py:111-114)."""
    t = i / 10.0
    return sr.look_down_pose(0.30 * t, 0.05 * np.sin(1.7 * t), 5.0,
                             yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))


def render_frames(cfg: SceneConfig) -> dict[int, np.ndarray]:
    """uint8 frames for every seed and tracked index, in index order, from
    one generator (texture first, then each frame's noise)."""
    rng = np.random.default_rng(cfg.seed)
    tex = sr.block_texture(rng, block=cfg.tex_block)
    frames = {}
    for i in sorted(set(cfg.seed_frames) | set(cfg.track_frames)):
        R_cw, t_cw = bench_pose(i)
        img = sr.render_plane(R_cw, t_cw, np.asarray(cfg.K4), cfg.hw, tex,
                              tex_scale=cfg.tex_scale)
        img += rng.normal(0, cfg.noise_sigma, img.shape).astype(np.float32)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def pose_errors(R_cw, t_cw, i: int) -> tuple[float, float]:
    """(camera-centre error in world units, rotation error in degrees) of a
    numpy pose against frame i's ground truth."""
    Rg, tg = bench_pose(i)
    R_cw = np.asarray(R_cw, np.float64)
    c = -R_cw.T @ np.asarray(t_cw, np.float64)
    cg = -Rg.T.astype(np.float64) @ tg.astype(np.float64)
    cos = (np.trace(R_cw @ Rg.T.astype(np.float64)) - 1.0) / 2.0
    return float(np.linalg.norm(c - cg)), float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def _pose_on(i: int, device):
    R, t = bench_pose(i)
    return torch.from_numpy(R).to(device), torch.from_numpy(t).to(device)


def seed_map(cfg: SceneConfig, frames: dict, device):
    """Seed the map from the ground-truth keyframes; returns (map, view)."""
    p = cfg.orb
    cam = torch.tensor(cfg.K4, dtype=torch.float32, device=device)
    h, w = cfg.hw
    m = mapstate.empty_map(cfg.capacity, device)
    chunks = []
    for fi in cfg.seed_frames:
        R, t = _pose_on(fi, device)
        ff = extract(torch.from_numpy(frames[fi]).to(device), p)
        Rwc, twc = lie.se3_inverse(R, t)
        d = cameras.pinhole_unproject(cam, ff.xy) @ Rwc.T
        X = twc + (-twc[2] / d[:, 2])[:, None] * d      # onto z = 0
        normal, min_d, max_d = mapping.point_descriptor_stats(
            X, ff.desc, twc, ff.octave, p.scale_factor, p.n_levels)
        m, ki = mapstate.add_keyframe(m, R, t, fi / 10.0, fi)
        m, pidx = mapstate.add_points(m, X, ff.desc, normal, min_d, max_d,
                                      ki, fi, ff.valid)
        chunks.append((X, pidx, ff.octave))
    for k, fi in enumerate(cfg.seed_frames):
        R, t = _pose_on(fi, device)
        for X, pidx, octave in chunks:
            Xc = lie.se3_apply(R, t, X)
            uv = cameras.pinhole_project(cam, Xc)
            inside = (Xc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
                (uv[:, 1] >= 0) & (uv[:, 1] < h)
            m = mapstate.add_observations(m, k, pidx, uv, octave, inside)
    view = mapstate.gather_local_view(m, len(cfg.seed_frames) - 1,
                                      cfg.view_points, window=cfg.view_kfs)
    return m, view


def track(cfg: SceneConfig, m, view, frames: dict, device):
    """Track cfg.track_frames with the per-frame step.  Returns (map,
    list of (frame, R_cw, t_cw, n_inliers) in numpy, per-frame seconds).
    Frames are staged on the device first; each frame's time is the host
    clock around the step up to a synchronise (on a CUDA device)."""
    p = cfg.orb
    cam = torch.tensor(cfg.K4, dtype=torch.float32, device=device)
    f0 = cfg.track_frames[0]
    R_prev, t_prev = _pose_on(f0 - 2, device)
    R_cur, t_cur = _pose_on(f0 - 1, device)
    imgs = {i: torch.from_numpy(frames[i]).to(device) for i in cfg.track_frames}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    out, secs = [], []
    for fi in cfg.track_frames:
        t0 = time.perf_counter()
        m, _, R, t, _, n_inl = frame_step.track_frame(
            m, view, imgs[fi], R_prev, t_prev, R_cur, t_cur, p, cam, cfg.hw,
            radius_th=cfg.radius_th)
        sync()
        secs.append(time.perf_counter() - t0)
        out.append((fi, R, t, n_inl))
        R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
    return m, [(fi, R.cpu().numpy(), t.cpu().numpy(), int(n))
               for fi, R, t, n in out], secs


def check_gates(cfg: SceneConfig, results) -> list[str]:
    """Gate failures (empty = every frame passed)."""
    bad = []
    for fi, R, t, n_inl in results:
        dc, dr = pose_errors(R, t, fi)
        # written so that a NaN error fails the gate
        if not (n_inl >= cfg.min_inliers and dc <= cfg.max_center_err
                and dr <= cfg.max_rot_err_deg):
            bad.append(f"frame {fi}: inliers {n_inl}, centre err {dc:.4g}, "
                       f"rot err {dr:.4g} deg")
    return bad
