"""The other sensors' drives, with ground truth and gates: the stereo, RGB-D
and KB8 monocular Systems on bench.py's path, and the raw-fisheye
stereo-inertial System on tests/test_fisheye_direct_stereo.py's scene.

bench.py's path (`seeded_scene`: a textured ground plane seen from 5 units
above, frame i at t = i / 10, sensor noise of sigma 1.5) gives:

  * a rectified stereo pair per frame: the left image is `seeded_scene`'s
    frame, the right camera is the left one shifted by `STEREO_BASELINE`
    (EuRoC's rectified baseline, `config.euroc_stereo`) along its x axis,
    rendered from the same texture with its own noise (generator
    `RIGHT_NOISE_SEED`);
  * a depth image per frame for RGB-D: per pixel the z at which its
    pinhole ray meets the ground plane (the scene has no mesas);
  * a fisheye view per frame with the TUM-VI camera (`config.tumvi_mono`:
    KB8 at 512x512), through `synth_render.kb8_rays` (supersampled, with a
    field stop; `render_fisheye_frames` says why).

The fisheye stereo-inertial scene (`FisheyeSIScene`) is the raw-KB8 drive of
tests/test_fisheye_direct_stereo.py:137-234: a textured plane with ten
mesas, the camera translating 3 units above it at 10 frames per second, a
200 Hz accelerometer from the analytic path, a rig of baseline 0.2 with a
small rotation, 70 frames.  Its defaults put the TUM-VI camera (TUM-VI cam0's
KB8 parameters at 512x512, 1000 features) on both sides of that rig;
`FisheyeSIScene.test_camera()` is the test's own (384x384, 800 features).

The drives feed frames through each System's public entry points and
nothing else, so that a test can run the JAX package's Systems through
them as well.  NumPy only, apart from the Systems.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np

from .. import config as presets
from ..io import euroc as euroc_io
from ..pipeline import inertial_system, stereo_system, system
from . import align
from . import seeded_scene as scene
from . import synth_render as sr

STEREO_BASELINE = 0.110074    # config.euroc_stereo's rectified baseline
RIGHT_NOISE_SEED = 11         # the right images' sensor noise
FISHEYE_SUPERSAMPLE = 3       # rays per pixel side in the fisheye render
FISHEYE_FIELD_STOP = 0.9      # rad off the axis: the fisheye render's image circle

# chip_smoke.py phase 11's bounds.  Each comes from the JAX package's System
# on the same frames on the CPU (the slow tests test_phase_11a/b/d in
# tests/test_torch_stereo.py, test_torch_rgbd.py and test_torch_kb8.py print
# its numbers), with about twice its error as the bound:
STEREO_MAX_ATE = 0.025          # JAX StereoSystem: rigid ATE 0.0123
STEREO_MAX_SCALE_ERR = 0.025    # JAX: Umeyama scale 1.0119
RGBD_MAX_ATE = 0.005            # JAX RGBDSystem: rigid ATE 0.0023
RGBD_MAX_SCALE_ERR = 0.005      # JAX: scale 1.0010
FISHEYE_INIT_BY = 8             # JAX KB8 System: initialized at frame 5
FISHEYE_MAX_ATE_RATIO = 0.08    # phase 6's bound; JAX: 0.0055 of the span


# --- bench.py's path: stereo, RGB-D, fisheye ------------------------------------

def stereo_configs(cfg: scene.SceneConfig, **overrides):
    """(SlamConfig, StereoConfig): bench.py's System configuration
    (`seeded_scene.system_config`) with stereo_bf = fx * STEREO_BASELINE."""
    slam = dataclasses.replace(scene.system_config(cfg), stereo_bf=cfg.K4[0] * STEREO_BASELINE,
                               **overrides)
    return slam, stereo_system.StereoConfig(baseline=STEREO_BASELINE)


def right_pose(i: int):
    """(R_cw, t_cw) of frame i's right camera: the left one moved by the
    baseline along its own x axis."""
    R, t = scene.bench_pose(i)
    return R, (t - np.array([STEREO_BASELINE, 0.0, 0.0])).astype(np.float32)


def _texture(cfg: scene.SceneConfig) -> np.ndarray:
    """`seeded_scene.render_frames`'s texture (the first draw of its
    generator)."""
    return sr.block_texture(np.random.default_rng(cfg.seed), block=cfg.tex_block)


def _noisy(img: np.ndarray, rng, sigma: float) -> np.ndarray:
    img = img + rng.normal(0, sigma, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def render_right_frames(cfg: scene.SceneConfig) -> dict[int, np.ndarray]:
    """uint8 right images of cfg.track_frames."""
    tex = _texture(cfg)
    rng = np.random.default_rng(RIGHT_NOISE_SEED)
    return {i: _noisy(sr.render_plane(*right_pose(i), np.asarray(cfg.K4), cfg.hw, tex,
                                      tex_scale=cfg.tex_scale, mesas=()), rng, cfg.noise_sigma)
            for i in sorted(cfg.track_frames)}


def depth_images(cfg: scene.SceneConfig) -> dict[int, np.ndarray]:
    """float32 (H, W) metric depth of cfg.track_frames: the camera-frame z
    where each pixel's ray meets the plane z = 0."""
    rays = sr.pinhole_rays(cfg.K4, cfg.hw).astype(np.float64)
    out = {}
    for i in sorted(cfg.track_frames):
        R_cw, t_cw = scene.bench_pose(i)
        Rwc = R_cw.T.astype(np.float64)
        twc = -Rwc @ t_cw.astype(np.float64)
        dz = rays @ Rwc[2]                 # the rays' world z (their camera z is 1)
        out[i] = np.where(dz > 1e-6, -twc[2] / np.maximum(dz, 1e-6), 0.0).astype(np.float32)
    return out


def fisheye_config(**overrides) -> system.SlamConfig:
    """`config.tumvi_mono` (the TUM-VI KB8 camera at 512x512, 1000 features)
    with bench.py's System settings (`min_init_matches=60`,
    `min_track_inliers=20`, `max_frames_between_kf=6`)."""
    return presets.tumvi_mono(min_init_matches=60, min_track_inliers=20,
                              max_frames_between_kf=6, **overrides)


def render_fisheye_frames(cfg: scene.SceneConfig, fcfg: system.SlamConfig) -> dict:
    """uint8 fisheye views of bench.py's path at cfg.track_frames through
    `fcfg`'s KB8 camera, from `seeded_scene`'s texture and noise model.
    Three things differ from a pinhole render, each for a stated reason:

      * the texture scale is cfg.tex_scale * fx_kb8 / fx_pinhole, so that a
        texture block spans as many pixels at the image centre as in the
        pinhole frames (at bench.py's 60 per unit, 190 px of focal length
        makes 6-pixel blocks whose descriptors do not match across frames);
      * each pixel is the mean of FISHEYE_SUPERSAMPLE^2 rays over its area:
        toward the horizon a fisheye pixel covers many texture blocks, and a
        single ray per pixel turns them into noise that FAST takes for
        corners;
      * a field stop at FISHEYE_FIELD_STOP rad off the axis (black beyond):
        the JAX package's KB8 initialization reconstructs on bearings over a
        unit virtual pinhole with the pixel sigma scaled by 1 / fx
        (system.py:212-228), so that matches far off the axis, stretched by
        up to 1 / cos^2 of their angle there, fail its chi2, and a render
        whose keypoints lie mostly there does not initialize."""
    p = tuple(float(v) for v in fcfg.cam_params)
    (H, W), s = fcfg.image_hw, FISHEYE_SUPERSAMPLE
    # the (s H, s W) camera whose s x s blocks tile each pixel of (H, W)
    p_hi = (p[0] * s, p[1] * s, p[2] * s + (s - 1) / 2, p[3] * s + (s - 1) / 2) + p[4:]
    rays = sr.kb8_rays(p_hi, (H * s, W * s))
    inside = sr.kb8_rays(p, (H, W))[..., 2] > np.cos(FISHEYE_FIELD_STOP)
    tex = _texture(cfg)
    tex_scale = cfg.tex_scale * p[0] / cfg.K4[0]
    rng = np.random.default_rng(cfg.seed + 1)
    out = {}
    for i in sorted(cfg.track_frames):
        img = sr.render_plane(*scene.bench_pose(i), np.asarray(p_hi[:4]), (H * s, W * s), tex,
                              tex_scale=tex_scale, mesas=(), rays=rays)
        out[i] = _noisy(np.where(inside, img.reshape(H, s, W, s).mean(axis=(1, 3)), 0.0)
                        .astype(np.float32), rng, cfg.noise_sigma)
    return out


# --- the raw-fisheye stereo-inertial scene -------------------------------------

G_W = np.array([0.0, 0.0, 9.81])


def _exp_so3(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


@dataclasses.dataclass(frozen=True)
class FisheyeSIScene:
    """tests/test_fisheye_direct_stereo.py:137-234 with the TUM-VI camera
    (the KB8 parameters of `io.euroc.TUMVI_CAM0` at 512x512, 1000 features)
    on both sides of the test's rig."""
    hw: tuple = tuple(euroc_io.TUMVI_CAM0["resolution"])
    kb8: tuple = tuple(euroc_io.TUMVI_CAM0["params"])
    n_features: int = 1000
    baseline: float = 0.2
    frames: int = 70
    fps: float = 10.0
    imu_hz: float = 200.0
    seed: int = 12
    # the test's gates
    max_ate: float = 0.10
    max_scale_err: float = 0.05

    @staticmethod
    def test_camera() -> "FisheyeSIScene":
        """The test's own camera: 384x384, KB8 (160, 160, 192, 192, ...), 800
        features."""
        return FisheyeSIScene(hw=(384, 384), kb8=(160.0, 160.0, 192.0, 192.0,
                                                  0.0035, 0.0007, -0.002, 0.0002),
                              n_features=800)

    def rig(self):
        """(R_rel, t_rel, T_rl): right <- left."""
        R_rel = _exp_so3([0.004, -0.006, 0.003])
        t_rel = -R_rel @ np.array([self.baseline, 0.0, 0.0])
        T_rl = np.eye(4)
        T_rl[:3, :3], T_rl[:3, 3] = R_rel, t_rel
        return R_rel, t_rel, T_rl

    def configs(self):
        """(SlamConfig, InertialConfig, StereoConfig) of the test."""
        from ..features.extractor import OrbParams
        T_rl = self.rig()[2]
        cfg = system.SlamConfig(cam_model="kb8", cam_params=self.kb8, image_hw=self.hw,
                                orb=OrbParams(n_features=self.n_features, n_levels=8),
                                max_frames_between_kf=6, min_init_matches=60,
                                ba_caps=(24, 4096, 16384), stereo_bf=0.0)
        icfg = inertial_system.InertialConfig(imu_freq=self.imu_hz, init_time_s=1.2,
                                              init_min_kfs=4)
        scfg = stereo_system.StereoConfig(baseline=self.baseline, raw_fisheye=True,
                                          right_cam_params=self.kb8,
                                          T_rl=tuple(T_rl.reshape(-1).tolist()))
        return cfg, icfg, scfg

    @staticmethod
    def pos(t: float) -> np.ndarray:
        return np.array([0.22 * t + 0.35 * np.sin(0.7 * t), 0.30 * np.sin(1.1 * t),
                         -3.0 + 0.12 * np.sin(0.9 * t)])

    @staticmethod
    def acc_w(t: float) -> np.ndarray:
        return np.array([-0.35 * 0.49 * np.sin(0.7 * t), -0.30 * 1.21 * np.sin(1.1 * t),
                         -0.12 * 0.81 * np.sin(0.9 * t)])

    def render(self) -> list:
        """[(left, right)] float32 images without noise, as the test feeds
        them."""
        rng = np.random.default_rng(self.seed)
        tex = sr.block_texture(rng, block=10)
        mesas = tuple((x0, x0 + w, y0, y0 + h, -z) for x0, y0, w, h, z in
                      zip(rng.uniform(-2, 5, 10), rng.uniform(-2, 4, 10),
                          rng.uniform(0.8, 1.6, 10), rng.uniform(0.8, 1.6, 10),
                          rng.uniform(0.4, 1.0, 10)))
        R_rel, t_rel, _ = self.rig()
        rays = sr.kb8_rays(self.kb8, self.hw)
        R_cw = np.eye(3)
        out = []
        for i in range(self.frames):
            t_cw = -R_cw @ self.pos(i / self.fps)
            views = [(R_cw, t_cw), (R_rel @ R_cw, R_rel @ t_cw + t_rel)]
            out.append(tuple(sr.render_plane(R, t, self.kb8[:4], self.hw, tex, tex_scale=60.0,
                                              mesas=mesas, rays=rays) for R, t in views))
        return out

    def imu_samples(self, i: int) -> list:
        """(t, gyro, acc) of the samples in (t_{i-1}, t_i]: the camera is the
        body, its attitude constant, the accelerometer read at each
        interval's midpoint."""
        if i == 0:
            return []
        dt_f, dt_i = 1.0 / self.fps, 1.0 / self.imu_hz
        t0, t_frame = (i - 1) * dt_f, i * dt_f
        out, k = [], 1
        while t0 + k * dt_i <= t_frame + 1e-9:
            tm = t0 + k * dt_i
            out.append((tm, np.zeros(3), self.acc_w(tm - 0.5 * dt_i) - G_W))
            k += 1
        return out


# --- the drives -----------------------------------------------------------------

class SensorDrive(NamedTuple):
    """What `drive` saw, one entry per frame fed (the fields of
    `seeded_scene.SystemDrive`, so that `check_system_gates` reads it)."""
    frames: list       # frame index
    states: list       # tracking state after the frame
    seconds: list      # host clock around the frame's calls, synchronised
    inliers: list      # inliers of a tracked frame, None where none was tracked
    n_kf: list         # keyframes in the map after the frame
    init_frame: int    # position of the initialising frame, -1 if none
    n_init_points: int  # points of the map right after initialization


def drive(sys_, frames, step: Callable, sync=lambda: None, wrap=None,
          on_frame=None) -> SensorDrive:
    """Feed `frames` (indices) to `sys_` through `step(sys_, fi)` (a
    System's entry points).  `wrap(fi, sys_)` may return a context manager
    that the frame runs in; `on_frame(fi, sys_, was_state, was_imu_init,
    n_kf_before)` runs after each frame."""
    d = SensorDrive([], [], [], [], [], -1, 0)
    init_frame, n_init = -1, 0
    for n, fi in enumerate(frames):
        was = sys_.state
        was_init, n_kf = getattr(sys_, "imu_initialized", False), sys_.n_kf_host
        ctx = (wrap(fi, sys_) if wrap is not None else None) or contextlib.nullcontext()
        sync()
        t0 = time.perf_counter()
        with ctx:
            step(sys_, fi)
            sync()
        d.seconds.append(time.perf_counter() - t0)
        d.frames.append(fi)
        d.states.append(sys_.state)
        tracked = was in (system.OK, system.RECENTLY_LOST)
        d.inliers.append(sys_.last_track_inliers if tracked else None)
        d.n_kf.append(sys_.n_kf_host)
        if init_frame < 0 and was != system.OK and sys_.state == system.OK:
            # the counter's value now, read after the drive (the map's
            # tensors are never written in place): no read in the frame
            init_frame, n_init = n, sys_.map.n_pt
        if on_frame is not None:
            on_frame(fi, sys_, was, was_init, n_kf)
    return d._replace(init_frame=init_frame, n_init_points=int(n_init))


def stereo_step(left: dict, right: dict):
    return lambda sys_, fi: sys_.track_stereo(left[fi], right[fi], fi / 10.0)


def rgbd_step(left: dict, depth: dict):
    return lambda sys_, fi: sys_.track_rgbd(left[fi], depth[fi], fi / 10.0)


def mono_step(frames: dict):
    return lambda sys_, fi: sys_.track_monocular(frames[fi], fi / 10.0)


def fisheye_si_step(scn: FisheyeSIScene, images: list):
    def step(sys_, i):
        for s in scn.imu_samples(i):
            sys_.grab_imu(*s)
        sys_.track_stereo(*images[i], i / scn.fps)
    return step


def frame_kind(sys_, was_state: int, was_init: bool, n_kf_before: int) -> str:
    """What a depth sensor's frame did: "initialising frame",
    "initialization attempt", "lost frame", "keyframe frame", "tracked
    frame"; an inertial System's frames as `imu_scene.frame_kind` names
    them."""
    if hasattr(sys_, "imu_initialized"):
        from . import imu_scene
        return imu_scene.frame_kind(was_state, was_init, sys_, n_kf_before)
    if was_state not in (system.OK, system.RECENTLY_LOST):
        return "initialising frame" if sys_.state == system.OK else "initialization attempt"
    if sys_.state != system.OK:
        return "lost frame"
    return "keyframe frame" if sys_.n_kf_host > n_kf_before else "tracked frame"


# --- the gates ------------------------------------------------------------------

def metric_errors(est: np.ndarray, gt: np.ndarray) -> dict:
    """The trajectory against the ground-truth centres: rigid ATE RMSE (no
    scale), and the Umeyama scale with the RMSE after it."""
    rigid, _, _, _ = align.ate_rmse(est, gt, with_scale=False)
    rmse_s, s, _, _ = align.ate_rmse(est, gt)
    return dict(ate=float(rigid), scale=float(s), ate_scaled=float(rmse_s))


def bench_errors(sys_) -> dict:
    """`metric_errors` of a System's trajectory on bench.py's path."""
    est = np.stack([np.asarray(p[2], np.float64) for p in sys_.trajectory])
    gt = np.stack([-scene.bench_pose(int(round(ts * 10.0)))[0].T.astype(np.float64)
                   @ scene.bench_pose(int(round(ts * 10.0)))[1].astype(np.float64)
                   for ts, _, _ in sys_.trajectory])
    return metric_errors(est, gt)


def check_depth_gates(sys_, d: SensorDrive, max_ate: float, max_scale_err: float,
                      min_init_points: int = 100) -> tuple[list, dict]:
    """Gate failures of a stereo or RGB-D drive on bench.py's path (empty =
    passed) and its numbers: OK from the first frame with at least
    `min_init_points` points, OK on every frame, no reset and no map
    switch, every tracked frame with at least `min_track_inliers` inliers,
    the rigid ATE below `max_ate` and the Umeyama scale within
    `max_scale_err` of 1."""
    bad = []
    if d.init_frame != 0:
        return [f"not OK from the first pair (states {d.states[:5]})"], {}
    if d.n_init_points < min_init_points:
        bad.append(f"{d.n_init_points} points from the first pair")
    lost = [d.frames[i] for i, s in enumerate(d.states) if s != system.OK]
    if lost:
        bad.append(f"not OK on frames {lost}")
    if sys_.n_resets or sys_.n_map_switches:
        bad.append(f"{sys_.n_resets} resets, {sys_.n_map_switches} map switches")
    inl = [x for x in d.inliers if x is not None]
    if not inl or min(inl) < sys_.cfg.min_track_inliers:
        bad.append(f"tracked-frame inliers {inl}")
    st = dict(bench_errors(sys_), n_init_points=d.n_init_points, n_kf=sys_.n_kf_host,
              n_points=int(sys_.map.pt_valid.sum()),
              inliers=(min(inl), max(inl)) if inl else None)
    if not st["ate"] < max_ate:
        bad.append(f"rigid ATE {st['ate']:.4g} (bound {max_ate})")
    if not abs(st["scale"] - 1.0) < max_scale_err:
        bad.append(f"scale {st['scale']:.5f} (bound |s - 1| < {max_scale_err})")
    return bad, st


def check_fisheye_si_gates(scn: FisheyeSIScene, sys_, d: SensorDrive) -> tuple[list, dict]:
    """The test's gates: no reset, OK at the end, the IMU initialized, the
    rigid RMSE below `max_ate` and the Umeyama scale within `max_scale_err`
    of 1."""
    bad = []
    if sys_.n_resets:
        bad.append(f"{sys_.n_resets} resets")
    if sys_.state != system.OK:
        bad.append(f"state {sys_.state} at the end")
    if not sys_.imu_initialized:
        bad.append("IMU not initialized")
    if not sys_.trajectory:
        return bad + ["no trajectory"], {}
    est = np.stack([np.asarray(p[2], np.float64) for p in sys_.trajectory])
    gt = np.stack([scn.pos(t) for t, _, _ in sys_.trajectory])
    st = dict(metric_errors(est, gt), n_init_points=d.n_init_points, n_kf=sys_.n_kf_host,
              n_points=int(sys_.map.pt_valid.sum()), init_frame=d.init_frame)
    if not st["ate"] < scn.max_ate:
        bad.append(f"rigid ATE {st['ate']:.4g}")
    if not abs(st["scale"] - 1.0) < scn.max_scale_err:
        bad.append(f"scale {st['scale']:.5f}")
    return bad, st
