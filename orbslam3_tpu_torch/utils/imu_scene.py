"""The mono-inertial drive of `bench.py`'s `bench_full_inertial`
(bench.py:191-273) for the port's `InertialSystem`, with its gates.

The scene: camera equals body, flying over a textured ground plane with a
vertical bob and a yaw / tilt wobble, so that the accelerometer and the
gyroscope see the motion the inertial initialization needs; 480x752 at
K4 (400, 400, 376, 240), 10 frames per second, sensor noise of sigma 1.5,
the texture `block_texture(default_rng(7), block=10)`.  The IMU runs at
200 Hz; its readings are differentiated numerically from the analytic
pose path and sampled at each interval's midpoint (bench.py:240-249).
Frames and IMU readings are fed as bench.py's host loop feeds them
(bench.py:262-273): the samples of (t_{i-1}, t_i] through `grab_imu`, then
frame i as a uint8 image through `track_monocular`.  NumPy only, apart
from the System.

One change to bench.py's path: its bob, 0.35 sin(1.2 t), starts at t =
BOB_START and grows in over BOB_RAMP seconds (a quintic smoothstep, so the
accelerations stay continuous).  With the bob from t = 0 the camera moves
toward the plane while it initializes, the two best decompositions of the
plane's homography then explain every match equally well, and two-view
initialization refuses every pair (the reference's second < 0.75 best
test): on the CPU the JAX `InertialSystem` initializes only at frame 74,
its IMU at frame 106, and reaches no VIBA1 within bench.py's 128 frames.
Before BOB_START the path is bench_full_system's, which initializes by
frame 6.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np

from ..features.extractor import OrbParams
from ..pipeline import inertial_system, system
from . import align
from . import synth_render as sr

FPS = 10.0
IMU_HZ = 200.0
G = np.array([0.0, 0.0, -9.81])
BOB_START = 1.5   # s
BOB_RAMP = 1.0    # s


@dataclasses.dataclass(frozen=True)
class InertialScene:
    """bench_full_inertial's configuration (bench.py:210-227); `frames` is
    warmup + measure = 80 + 48."""
    hw: tuple = (480, 752)
    K4: tuple = (400.0, 400.0, 376.0, 240.0)
    orb: OrbParams = OrbParams(n_features=1200, n_levels=8)
    frames: int = 128
    seed: int = 7
    tex_block: int = 10
    tex_scale: float = 60.0
    noise_sigma: float = 1.5
    # gates (test_inertial_pipeline.py:112-114 for the scale and the ATE)
    init_imu_by: int = 80
    viba1_by: int = 127
    min_points: int = 200
    max_scale_err: float = 0.12
    max_ate: float = 0.1


def slam_config(cfg: InertialScene) -> system.SlamConfig:
    """bench.py's SlamConfig for the chain: the default map capacity."""
    return system.SlamConfig(cam_model="pinhole", cam_params=cfg.K4, image_hw=cfg.hw,
                             orb=cfg.orb, min_init_matches=60, min_track_inliers=20,
                             max_frames_between_kf=6)


def inertial_config() -> inertial_system.InertialConfig:
    """bench.py's InertialConfig: VIBA2 off (the run spans ~13 s)."""
    return inertial_system.InertialConfig(imu_freq=IMU_HZ, init_time_s=2.0, init_min_kfs=6,
                                          refine_time_s=5.0, refine2_time_s=1e9)


def bob(t: float) -> float:
    """The height above 5 units: bench.py's 0.35 sin(1.2 t), phase-shifted
    to start at BOB_START and ramped in."""
    x = min(max((t - BOB_START) / BOB_RAMP, 0.0), 1.0)
    return 0.35 * x ** 3 * (10.0 - 15.0 * x + 6.0 * x * x) * np.sin(1.2 * (t - BOB_START))


def pose(t: float):
    """Ground-truth (R_cw, t_cw) at time t."""
    return sr.look_down_pose(0.30 * t, 0.05 * np.sin(1.7 * t), 5.0 + bob(t),
                             yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))


def pos_w(t: float) -> np.ndarray:
    R_cw, t_cw = pose(t)
    return -(R_cw.T @ t_cw)


def imu_at(t: float, h: float = 1e-3):
    """(gyro, acc) in the body frame at time t, by central differences of
    the analytic path."""
    a_w = (pos_w(t + h) - 2.0 * pos_w(t) + pos_w(t - h)) / (h * h)
    R0 = pose(t)[0].T          # Rwb
    R1 = pose(t + h)[0].T
    dR = R0.T @ R1
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) * 0.5 / h
    return w.astype(np.float32), (R0.T @ (a_w - G)).astype(np.float32)


def render_frames(cfg: InertialScene) -> list:
    """uint8 frames 0..frames-1, from one generator: the texture first,
    then each frame's noise in order (bench.py:217-259)."""
    rng = np.random.default_rng(cfg.seed)
    tex = sr.block_texture(rng, block=cfg.tex_block)
    out = []
    for i in range(cfg.frames):
        R_cw, t_cw = pose(i / FPS)
        img = sr.render_plane(R_cw, t_cw, np.asarray(cfg.K4), cfg.hw, tex,
                              tex_scale=cfg.tex_scale, mesas=())
        img += rng.normal(0, cfg.noise_sigma, img.shape).astype(np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def imu_samples(i: int):
    """The samples that precede frame i: (t, gyro, acc) at 200 Hz over
    ((i-1)/FPS, i/FPS], each read at its interval's midpoint."""
    if i == 0:
        return []
    dt_i = 1.0 / IMU_HZ
    t0, t1 = (i - 1) / FPS, i / FPS
    out = []
    k = 1
    while t0 + k * dt_i <= t1 + 1e-9:
        tm = t0 + k * dt_i
        out.append((tm, *imu_at(tm - 0.5 * dt_i)))
        k += 1
    return out


class InertialDrive(NamedTuple):
    """What `drive` saw, one entry per frame fed."""
    states: list       # tracking state after the frame
    seconds: list      # host clock around grab_imu + track_monocular, synchronised
    kinds: list        # what the frame did (see `frame_kind`)
    n_kf: list         # keyframes in the map after the frame
    init_frame: int    # the initialising frame, -1 if none
    imu_init_frame: int   # the frame whose keyframe ran the IMU init, -1 if none
    viba1_frame: int


def frame_kind(was_state: int, was_init: bool, sys_, n_kf_before: int) -> str:
    """One of: "initialization attempt", "initialising frame", "tracked
    frame" (before the IMU init), "LastKeyFrame tracked frame", "LastFrame
    tracked frame", "keyframe frame" (visual BA), "inertial keyframe frame"
    (VI window BA), "IMU-init frame" (a keyframe that ran an IMU stage),
    "lost frame"."""
    if was_state not in (system.OK, system.RECENTLY_LOST):
        return "initialising frame" if sys_.state == system.OK else "initialization attempt"
    if sys_.state != system.OK:
        return "lost frame"
    if sys_.n_kf_host > n_kf_before:
        if sys_.last_imu_stage_frame == sys_.frame_id:
            return "IMU-init frame"
        return "inertial keyframe frame" if was_init else "keyframe frame"
    if not was_init:
        return "tracked frame"
    return "LastKeyFrame tracked frame" if sys_.last_vi_branch == "lastkf" else \
        "LastFrame tracked frame"


def expected_kind(sys_, i: int) -> str | None:
    """The kind (as `frame_kind` names it) that frame i should turn out to
    be, judged before it runs from what the System decides on the host:
    None before initialization.  A keyframe is expected when the frame gap
    reaches max_frames_between_kf (an inlier drop can add one), an IMU stage
    when the keyframe meets the stage's time and count."""
    if sys_.state != system.OK:
        return None
    cfg, icfg = sys_.cfg, sys_.icfg
    ts = i / FPS
    if sys_.frame_id + 1 - sys_.last_kf_id >= cfg.max_frames_between_kf:
        t0 = sys_.kf_time0
        elapsed = -1.0 if t0 is None else ts - t0
        if not sys_.imu_initialized:
            stage = len(sys_.preints) + 1 >= icfg.init_min_kfs and elapsed >= icfg.init_time_s
        else:
            stage = (not sys_.viba1_done and elapsed >= icfg.refine_time_s) or \
                (sys_.viba1_done and not sys_.viba2_done and elapsed >= icfg.refine2_time_s)
        if stage:
            return "IMU-init frame"
        return "inertial keyframe frame" if sys_.imu_initialized else "keyframe frame"
    if not sys_.imu_initialized:
        return "tracked frame"
    return "LastKeyFrame tracked frame" if sys_._map_updated or sys_.frame_prior is None \
        else "LastFrame tracked frame"


def drive(cfg: InertialScene, frames: list, device, sync=lambda: None, seed: int = 42,
          n_frames: int | None = None, on_frame=None, wrap=None):
    """Feed the frames with their IMU samples to a fresh `InertialSystem`
    (`device` None: the card).  `wrap(i, sys_)`, if given, returns a
    context manager (or None) that frame i runs in; `on_frame(i, sys_, kind)`
    runs after each frame.  Returns (InertialSystem, InertialDrive)."""
    sys_ = inertial_system.InertialSystem(slam_config(cfg), inertial_config(), device=device,
                                          seed=seed)
    d = InertialDrive([], [], [], [], -1, -1, -1)
    init_frame = imu_frame = viba1_frame = -1
    for i in range(cfg.frames if n_frames is None else n_frames):
        was, was_init, n_kf = sys_.state, sys_.imu_initialized, sys_.n_kf_host
        ctx = (wrap(i, sys_) if wrap is not None else None) or contextlib.nullcontext()
        samples = imu_samples(i)
        sync()
        t0 = time.perf_counter()
        with ctx:
            for s in samples:
                sys_.grab_imu(*s)
            state, _ = sys_.track_monocular(frames[i], ts=i / FPS)
            sync()
        d.seconds.append(time.perf_counter() - t0)
        d.states.append(state)
        d.n_kf.append(sys_.n_kf_host)
        d.kinds.append(frame_kind(was, was_init, sys_, n_kf))
        if init_frame < 0 and was != system.OK and state == system.OK:
            init_frame = i
        if imu_frame < 0 and sys_.imu_initialized:
            imu_frame = i
        if viba1_frame < 0 and sys_.viba1_done:
            viba1_frame = i
        if on_frame is not None:
            on_frame(i, sys_, d.kinds[-1])
    return sys_, d._replace(init_frame=init_frame, imu_init_frame=imu_frame,
                            viba1_frame=viba1_frame)


def metric_ate(sys_, from_ts: float):
    """Umeyama alignment with scale of the trajectory from `from_ts` on
    against the ground-truth positions: (rmse, scale)."""
    traj = [p for p in sys_.trajectory if p[0] >= from_ts - 1e-9]
    est = np.stack([p[2] for p in traj])
    gt = np.stack([pos_w(p[0]) for p in traj])
    rmse, s, _, _ = align.ate_rmse(est, gt, with_scale=True)
    return rmse, s


def check_gates(cfg: InertialScene, sys_, d: InertialDrive) -> tuple[list, dict]:
    """Gate failures (empty = passed) and the run's numbers: OK on every frame
    after initialization, no reset and no map switch, the IMU initialized by
    frame `init_imu_by` and VIBA1 done by frame `viba1_by`, more than
    `min_points` valid points, and the post-IMU-init trajectory metric:
    |s - 1| < max_scale_err and RMSE < max_ate after Umeyama with scale."""
    bad = []
    if d.init_frame < 0:
        return [f"never initialised (states {d.states})"], {}
    lost = [i for i in range(d.init_frame, len(d.states)) if d.states[i] != system.OK]
    if lost:
        bad.append(f"not OK on frames {lost}")
    if sys_.n_resets or sys_.n_map_switches:
        bad.append(f"{sys_.n_resets} resets, {sys_.n_map_switches} map switches")
    if not 0 <= d.imu_init_frame <= cfg.init_imu_by:
        bad.append(f"IMU initialized at frame {d.imu_init_frame}")
    if not 0 <= d.viba1_frame <= cfg.viba1_by:
        bad.append(f"VIBA1 done at frame {d.viba1_frame}")
    n_pts = int(sys_.map.pt_valid.sum())
    if n_pts <= cfg.min_points:
        bad.append(f"{n_pts} valid map points")
    stats = dict(init_frame=d.init_frame, imu_init_frame=d.imu_init_frame,
                 viba1_frame=d.viba1_frame, n_kf=sys_.n_kf_host,
                 n_kf_valid=int(sys_.map.kf_valid.sum()), n_points=n_pts)
    if d.imu_init_frame >= 0:
        rmse, s = metric_ate(sys_, d.imu_init_frame / FPS)
        stats.update(ate=rmse, scale=s)
        if not abs(s - 1.0) < cfg.max_scale_err:
            bad.append(f"trajectory scale {s:.4f} after the IMU init")
        if not rmse < cfg.max_ate:
            bad.append(f"ATE {rmse:.4f} after the IMU init")
    return bad, stats
