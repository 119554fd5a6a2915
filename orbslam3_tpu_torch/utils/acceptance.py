"""The JAX suite's end-to-end acceptance scenarios, on the port.

The port's own copy of what ten slow tests of the JAX package build and
assert, so that the port can run them where JAX is not installed (the card's
machine).  Each scenario is one function, `run_<letter>(device, ...)`, that
builds the test's inputs with NumPy from the test's seeds (the same calls in
the same order, so the inputs are bit-equal to the test's), drives the port
through the entry points the test drives, and returns the values the test
asserts, the gates' failures (`bad`, empty when every gate holds) and what
the drive did: frames OK, keyframes, the frame kinds with their host-clock
milliseconds (synchronised on a card).

  A `tests/test_frontend_e2e.py:33` test_mono_tracking_from_pixels: a
    36-frame lateral sweep over a textured plane with mesas at 240x376,
    `OrbParams(900, 4)`, each frame extracted and fed to `System`;
  B `tests/test_photometric_stress.py:42`: the same sweep under drifting
    exposure and gamma, vignetting, blur on every third frame, noise 4 and a
    low-texture band;
  C `tests/test_photometric_stress.py:105`: ORB repeatability, matching
    recall and precision across a change of view and light;
  D `tests/test_frontend_e2e.py:81`: four places cut from one texture and a
    revisit, ranked by the keyframe database over the trained vocabulary;
  E `tests/test_photometric_stress.py:160`: the same on a Voronoi texture
    family the vocabulary never saw, the revisit under stress;
  F `tests/test_inertial_chain.py:141`: mono-inertial on synthetic features
    with gyro and accelerometer noise at ten times EuRoC's, the VI pose
    optimization on;
  G `tests/test_stereo_inertial.py:17`: stereo-inertial on synthetic
    features, metric and gravity aligned;
  H `tests/test_long_run.py:47`: a 270-frame ring lap with loop closing on;
  I `tests/test_pipeline_e2e.py:78` test_mono_synthetic_sequence: 60 frames
    of synthetic features through the monocular `System`;
  J `tests/test_fisheye_stereo_inertial.py:40` test_pixels_to_metric_trajectory:
    70 raw KB8 fisheye pairs at 384x384 rectified onto a shared pinhole
    (`io.rectify.stereo_rectify(model="kb8")`, `io.euroc.apply_undistort`),
    `OrbParams(800, 8)`, both images of each pair extracted by the
    `StereoInertialSystem` with a 200 Hz accelerometer and the fixed-scale
    IMU initialization (TUM-VI's configuration).

A-E and J extract every image on the device (`orb_describe` once per
`extract`: J twice per frame); F-I feed synthetic features.  `depth`
arguments (`n_frames`, F's, G's and J's `after_imu`) cut a drive to its
first frames; the inputs of those frames do not change.  On a card, `run_*`
also holds one step against the CPU (`card_check`): for A-E the first
image's extraction (keypoints equal, descriptor bits off counted), for F-I
the first tracked frame after the map exists, from a CPU copy of the state
before it (`system_to`), for J the extraction and its first two tracked
frames.  J's first tracked frame is taken at the initialization's pose,
where every predicted scale level lies within a float rounding of an
integer, so the CPU runs it with the card's levels (`predicted_levels`),
and the levels that differ are counted.  NumPy and torch only.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..features.extractor import FeatureFrame, OrbParams, extract
from ..io import euroc as euroc_io
from ..io import rectify
from ..ops import brief, lie, matching
from ..pipeline import (inertial_system, loop_closing, stereo_inertial_system,
                        stereo_system, system)
from ..place import keyframe_db as kdb
from . import align
from . import loop_scene
from . import sensor_scene
from . import synth_render as sr
from . import synthetic_world as sw

# the front-end scenes' camera and image (A-E)
HW = (240, 376)
K4 = (230.0, 230.0, 188.0, 120.0)
SWEEP_FRAMES = 36
# D and E: the four places of one texture and the revisit of place 2
SPOTS = ((0.5, 0.5), (4.0, 1.0), (1.0, 4.5), (5.0, 5.0))
REVISIT = dict(x=1.06, y=4.46, zdist=5.15, yaw=0.06)
TRUE_PLACE = 2
# F: EuRoC-class gyro and accelerometer noise densities, times 10
SG = 1.7e-4 * np.sqrt(sw.IMU_HZ) * 10
SA = 2.0e-3 * np.sqrt(sw.IMU_HZ) * 10
STEREO_BASELINE = 0.11      # tests/test_stereo.py's rectified baseline


def orb_params() -> OrbParams:
    return OrbParams(n_features=900, n_levels=4)


def frontend_config() -> system.SlamConfig:
    """A and B's `SlamConfig`."""
    return system.SlamConfig(
        cam_model="pinhole", cam_params=K4, image_hw=HW, orb=orb_params(),
        min_init_matches=60, min_track_inliers=20, max_frames_between_kf=6,
        new_pt_budget=512, ba_caps=(16, 2048, 8192))


# --- A-E: the rendered scenes --------------------------------------------------

def sweep_pose(i: int):
    """(R_cw, t_cw) of the lateral sweep's frame i (t = i / 10)."""
    t = i / 10.0
    return sr.look_down_pose(0.35 * t, 0.05 * np.sin(1.7 * t), 5.0,
                             yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))


def render_noisy(R_cw, t_cw, tex, rng) -> np.ndarray:
    """tests/test_frontend_e2e.py's `_render`: the plane with the JAX
    package's default mesas, noise of sigma 1.5 drawn after the render,
    clipped float32."""
    img = sr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex, tex_scale=40.0)
    img += rng.normal(0, 1.5, img.shape).astype(np.float32)
    return np.clip(img, 0, 255)


def stress_params(i: int, n_frames: int) -> dict:
    """B's photometric regime at frame i: exposure 0.65 -> 1.35, gamma
    1.15 -> 0.85, vignette 0.35, blur 2.5 px on every third frame, noise 4."""
    u = i / max(n_frames - 1, 1)
    return dict(exposure=0.65 + 0.7 * u, gamma=1.15 - 0.3 * u, vignette=0.35,
                blur_px=2.5 if i % 3 == 0 else 0.0, blur_dir=(1.0, 0.4), noise=4.0)


def sweep_images(stress: bool, n_frames: int = SWEEP_FRAMES):
    """A's (stress=False) or B's frames: (images, true camera centres).
    The texture, then each frame's noise, from one generator (seed 11), as
    the tests draw them; B's texture has a band of constant grey (columns
    340-439, 2.5 world units) across the path."""
    rng = np.random.default_rng(11)
    tex = sr.block_texture(rng, block=10)
    if stress:
        tex[:, 340:440] = 128.0
    images, centres = [], []
    for i in range(n_frames):
        R_cw, t_cw = sweep_pose(i)
        if stress:
            img = sr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex, tex_scale=40.0)
            img = sr.photometric_stress(img, rng=rng, **stress_params(i, SWEEP_FRAMES))
        else:
            img = render_noisy(R_cw, t_cw, tex, rng)
        images.append(img)
        centres.append(-R_cw.T @ t_cw)
    return images, centres


def repeatability_images():
    """C's pair: (img1, img2, (R1, t1), (R2, t2)); the plane without mesas,
    the second view 0.5 units aside and 8 degrees of yaw away, under
    exposure 1.3, gamma 0.85, vignette 0.3 and noise 4 (seed 7)."""
    rng = np.random.default_rng(7)
    tex = sr.block_texture(rng, block=10)
    R1, t1 = sr.look_down_pose(1.0, 1.0, 5.0)
    R2, t2 = sr.look_down_pose(1.5, 1.15, 5.1, yaw=0.14)
    img1 = sr.render_plane(R1, t1, np.asarray(K4), HW, tex, tex_scale=40.0, mesas=())
    img2 = sr.render_plane(R2, t2, np.asarray(K4), HW, tex, tex_scale=40.0, mesas=())
    img1 = sr.photometric_stress(img1, noise=2.0, rng=rng)
    img2 = sr.photometric_stress(img2, exposure=1.3, gamma=0.85, vignette=0.3, noise=4.0,
                                 rng=rng)
    return img1, img2, (R1, t1), (R2, t2)


def place_images(unseen: bool):
    """D's (unseen=False) or E's images: the four places, then the revisit
    (seed 23).  D: a block texture, each image as `render_noisy`.  E: a
    Voronoi texture of 700 cells, the places under noise 1.5, the revisit
    under exposure 1.25, gamma 0.88, vignette 0.3 and noise 4."""
    rng = np.random.default_rng(23)
    tex = sr.voronoi_texture(rng, n_seeds=700) if unseen else sr.block_texture(rng, block=10)

    def shot(R_cw, t_cw, **stress):
        if not unseen:
            return render_noisy(R_cw, t_cw, tex, rng)
        img = sr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex, tex_scale=40.0)
        return sr.photometric_stress(img, rng=rng, **stress)

    places = [shot(*sr.look_down_pose(x, y, 5.0), noise=1.5) for x, y in SPOTS]
    revisit = shot(*sr.look_down_pose(**REVISIT), exposure=1.25, gamma=0.88, vignette=0.3,
                   noise=4.0)
    return places, revisit


def plane_map_xy(xy, R1, t1, R2, t2):
    """Keypoints of view 1 carried into view 2 through the z = 0 plane
    (tests/test_photometric_stress.py's `_plane_map_xy`): (pixels, in front)."""
    fx, fy, cx, cy = K4
    rays = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy, np.ones(len(xy))], 1)
    Rwc1 = R1.T
    d_w = rays @ Rwc1.T
    Ow1 = -Rwc1 @ t1
    s = -Ow1[2] / np.where(np.abs(d_w[:, 2]) < 1e-9, 1e-9, d_w[:, 2])
    Xw = Ow1[None] + s[:, None] * d_w
    Xc2 = Xw @ R2.T + t2[None]
    z = np.maximum(Xc2[:, 2], 1e-6)
    return np.stack([fx * Xc2[:, 0] / z + cx, fy * Xc2[:, 1] / z + cy], 1), Xc2[:, 2] > 0


# --- F-I: the feature worlds ----------------------------------------------------

class StereoWorld(sw.SyntheticWorld):
    """tests/test_stereo.py's world: rectified left / right feature frames."""

    def stereo_frame(self, R_cw, t_cw, noise_px=0.3, device="cpu"):
        K, (H, W) = sw.K4, sw.HW
        Xc = self.X @ np.asarray(R_cw).T + np.asarray(t_cw)
        z = Xc[:, 2]
        ul = K[0] * Xc[:, 0] / np.maximum(z, 1e-6) + K[2]
        v = K[1] * Xc[:, 1] / np.maximum(z, 1e-6) + K[3]
        ur = ul - K[0] * STEREO_BASELINE / np.maximum(z, 1e-6)
        vis = (z > 0.3) & (ul > 10) & (ul < W - 10) & (v > 10) & (v < H - 10) & (ur > 5)
        vis &= self.rng.random(len(z)) > 0.15
        idx = np.nonzero(vis)[0]
        self.rng.shuffle(idx)
        idx = idx[:sw.N_KP]
        n = len(idx)
        noise = lambda k: noise_px * self.rng.standard_normal(k)
        xy_l = np.stack([ul[idx] + noise(n), v[idx] + noise(n)], 1)
        xy_r = np.stack([ur[idx] + noise(n), v[idx] + noise(n)], 1)
        desc = self.desc[idx]
        return (loop_scene.make_frame(xy_l.astype(np.float32), desc, sw.N_KP, device),
                loop_scene.make_frame(xy_r.astype(np.float32), desc, sw.N_KP, device))


class RingWorld:
    """tests/test_long_run.py's world: 6000 landmarks in a ring of radius
    10-16 around the origin; a frame keeps the visible ones with the
    highest response, with pixel noise.  Descriptors are uint32 on the host
    and int32 bit patterns in the frames."""

    def __init__(self, seed=31, n=6000, R=8.0):
        rng = np.random.default_rng(seed)
        th = rng.uniform(0, 2 * np.pi, n)
        r = rng.uniform(R + 2, R + 8, n)
        self.X = np.stack([r * np.cos(th), rng.uniform(-2, 2, n), r * np.sin(th)],
                          1).astype(np.float32)
        self.desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        self.response = rng.random(n)
        self.rng = rng

    def frame(self, R_cw, t_cw, noise_px=0.3, device="cpu") -> FeatureFrame:
        K, (H, W) = sw.K4, sw.HW
        Xc = self.X @ np.asarray(R_cw).T + np.asarray(t_cw)
        z = Xc[:, 2]
        uv = np.stack([K[0] * Xc[:, 0] / np.maximum(z, 1e-6) + K[2],
                       K[1] * Xc[:, 1] / np.maximum(z, 1e-6) + K[3]], 1)
        vis = (z > 1.0) & (z < 14) & (uv[:, 0] > 10) & (uv[:, 0] < W - 10) & \
            (uv[:, 1] > 10) & (uv[:, 1] < H - 10)
        vis &= self.rng.random(len(z)) > 0.1
        idx = np.nonzero(vis)[0]
        idx = idx[np.argsort(-self.response[idx])][:sw.N_KP]
        xy = uv[idx] + noise_px * self.rng.standard_normal((len(idx), 2))
        return loop_scene.make_frame(xy.astype(np.float32), self.desc[idx], sw.N_KP, device)


def ring_poses(n_frames: int = 270, lap: int = 240):
    """H's camera: (R_cw, t_cw, centre) per frame, on a circle of radius 8
    looking along it, one lap per `lap` frames; the yaw through the port's
    `lie.exp_so3` in float32."""
    out = []
    for i in range(n_frames):
        phi = 2 * np.pi * i / lap
        c = np.array([8.0 * np.cos(phi), 0.0, 8.0 * np.sin(phi)])
        Rwc = lie.exp_so3(torch.tensor([0.0, -phi + np.pi / 2, 0.0], dtype=torch.float32)).numpy()
        R_cw = Rwc.T.astype(np.float32)
        out.append((R_cw, (-R_cw @ c).astype(np.float32), c))
    return out


def noisy_imu_between(t0: float, t1: float, rot, acc, rot_rate, rng):
    """F's samples of (t0, t1]: `synthetic_world.imu_between`'s, with the
    accelerometer's noise (sigma SA) drawn before the gyro's (SG) at each
    sample, as the test draws them."""
    dt_i = 1.0 / sw.IMU_HZ
    out = []
    k = 1
    while t0 + k * dt_i <= t1 + 1e-9:
        tm = t0 + k * dt_i
        Rb = rot(tm - 0.5 * dt_i)
        a_body = Rb.T @ (acc(tm - 0.5 * dt_i) - sw.G) + rng.normal(0, SA, 3)
        w_body = rot_rate(tm - 0.5 * dt_i) + rng.normal(0, SG, 3)
        out.append((tm, w_body, a_body))
        k += 1
    return out


# --- the drives -----------------------------------------------------------------

class Held(NamedTuple):
    """A tracked frame held against the CPU."""
    frame: int
    pose: tuple         # (R_cw, t_cw, inliers) after it, on the host
    cpu_copy: object    # the System on the CPU from just before it
    levels: list        # with `with_levels`: the predicted scale levels of its step
    #                     (`tracking.predict_scale`, in call order), else None
    levels_copy: object  # with `with_levels`: a second copy, to run with `levels`


class Drive(NamedTuple):
    """What `drive` saw, one entry per frame fed."""
    states: list        # tracking state after the frame
    inliers: list       # inliers of a tracked frame, None where none was tracked
    kinds: list         # `sensor_scene.frame_kind` of the frame
    seconds: list       # host clock around the frame's step (synchronised on a card)
    init_frame: int     # the first frame after which the state was OK, -1 if none
    held: list          # `Held` per tracked frame held against the CPU, when asked


def _sync(dev: torch.device) -> Callable:
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)


@contextlib.contextmanager
def predicted_levels(tape: list, play: bool = False):
    """Within it, every predicted scale level (`tracking.predict_scale`, which
    local-map tracking and fusion call) is appended to `tape` on the host,
    or, with `play`, taken from `tape` in call order in place of the one
    computed here.  Yields a dict: `calls`, `differ` (levels played that
    differ from the computed ones), `mismatched` (calls with no entry of
    their shape on the tape, and entries left unplayed)."""
    from ..pipeline import fusion, tracking
    own = tracking.predict_scale
    seen = {"calls": 0, "differ": 0, "mismatched": 0}

    def taped(dist, max_dist, scale_factor, n_levels):
        lv = own(dist, max_dist, scale_factor, n_levels)
        k = seen["calls"]
        seen["calls"] += 1
        if not play:
            tape.append(lv.cpu())
            return lv
        if k >= len(tape) or tape[k].shape != lv.shape:
            seen["mismatched"] += 1
            return lv
        forced = tape[k].to(lv.device)
        seen["differ"] += int((forced != lv).sum())
        return forced

    tracking.predict_scale = fusion.predict_scale = taped
    try:
        yield seen
    finally:
        tracking.predict_scale = fusion.predict_scale = own
    if play:
        seen["mismatched"] += max(0, len(tape) - seen["calls"])     # entries not played


def drive(sys_, n_frames: int, step: Callable, dev, stop: Callable | None = None,
          keep_copy: bool = False, hold: int = 1, with_levels: int = 0) -> Drive:
    """Feed frames 0..n_frames-1 through `step(sys_, i)` (the System's entry
    points); `stop(sys_, i)` may end the drive after frame i.  With
    `keep_copy`, the System's state just before each of its first `hold`
    tracked frames is copied to the CPU (outside the timed step); the first
    `with_levels` of them also record their step's predicted scale levels
    (`predicted_levels`) and keep a second copy to run with them."""
    sync = _sync(dev)
    d = Drive([], [], [], [], -1, [])
    n_tracked = 0
    for i in range(n_frames):
        was, n_kf = sys_.state, sys_.n_kf_host
        was_init = getattr(sys_, "imu_initialized", False)
        held = keep_copy and was == system.OK and n_tracked < hold
        taped = held and n_tracked < with_levels
        n_tracked += was == system.OK
        if held:
            copies = [system_to(sys_, "cpu") for _ in range(1 + taped)]
        tape: list = []
        sync()
        t0 = time.perf_counter()
        if taped:
            with predicted_levels(tape):
                step(sys_, i)
        else:
            step(sys_, i)
        sync()
        d.seconds.append(time.perf_counter() - t0)
        d.states.append(sys_.state)
        tracked = was in (system.OK, system.RECENTLY_LOST)
        d.inliers.append(sys_.last_track_inliers if tracked else None)
        d.kinds.append(sensor_scene.frame_kind(sys_, was, was_init, n_kf))
        if d.init_frame < 0 and was != system.OK and sys_.state == system.OK:
            d = d._replace(init_frame=i)
        if held:
            R, t = sys_._pose_numpy()
            d.held.append(Held(i, (R, t, sys_.last_track_inliers), copies[0],
                               tape if taped else None, copies[1] if taped else None))
        if stop is not None and stop(sys_, i):
            break
    return d


def _kind_ms(d: Drive) -> dict:
    """Per frame kind: (median host-clock ms, frames)."""
    out: dict = {}
    for k, s in zip(d.kinds, d.seconds):
        out.setdefault(k, []).append(s * 1e3)
    return {k: (float(np.median(v)), len(v)) for k, v in out.items()}


def _on(ff: FeatureFrame, dev) -> FeatureFrame:
    return FeatureFrame(*(x.to(dev) for x in ff))


def _ate(sys_, centre_of: Callable, with_scale: bool = True, half: bool = False):
    """(rmse, scale, span) of the System's trajectory against the true
    centres `centre_of(ts)`; `half`: its second half only."""
    if not sys_.trajectory:
        return float("nan"), float("nan"), float("nan")
    est = np.stack([np.asarray(p[2], np.float64) for p in sys_.trajectory])
    gt = np.stack([np.asarray(centre_of(p[0]), np.float64) for p in sys_.trajectory])
    if half:
        est, gt = est[len(est) // 2:], gt[len(gt) // 2:]
    rmse, s, _, _ = align.ate_rmse(est, gt, with_scale=with_scale)
    return float(rmse), float(s), float(np.linalg.norm(gt.max(0) - gt.min(0)))


def _summary(name: str, sys_, d: Drive, gates: dict, bad: list, t0: float, **extra) -> dict:
    return dict(name=name, gates=gates, bad=bad, frames=len(d.states),
                ok=sum(s == system.OK for s in d.states), keyframes=sys_.n_kf_host,
                n_resets=sys_.n_resets, init_frame=d.init_frame, kinds=_kind_ms(d),
                seconds=time.perf_counter() - t0, **extra)


def _track_check(d: Drive, step: Callable) -> tuple[list, list]:
    """Each held tracked frame again on the CPU copy of the state before it:
    the pose within 1e-4 and the same inliers as on the card.  A frame held
    with its levels is run twice on the CPU, as it is (`plain_pose`,
    `plain_inliers`, reported) and with the card's predicted scale levels
    in place of the CPU's (`levels_differ` of them differ), which the gate
    reads; every level of the card's step must have been played."""
    bad, out = [], []
    for h in d.held:
        Rc, tc, n = h.pose

        def rerun(s):
            step(s, h.frame)
            R, t = s._pose_numpy()
            diff = max(float(np.abs(R - Rc).max()), float(np.abs(t - tc).max()))
            return diff, s.last_track_inliers

        diff, n_cpu = rerun(h.cpu_copy)
        c = dict(frame=h.frame, pose=diff, inliers=(n, n_cpu))
        if h.levels is not None:
            with predicted_levels(h.levels, play=True) as seen:
                diff, n_cpu = rerun(h.levels_copy)
            c = dict(frame=h.frame, pose=diff, inliers=(n, n_cpu), levels_differ=seen["differ"],
                     plain_pose=c["pose"], plain_inliers=c["inliers"])
            if seen["mismatched"]:
                bad.append(f"card against the CPU at frame {h.frame}: {seen['mismatched']} "
                           f"predicted-level calls of {seen['calls']} not matched on the tape "
                           f"of {len(h.levels)}")
        if not (diff <= 1e-4 and n == n_cpu):
            bad.append(f"card against the CPU at frame {h.frame}"
                       f"{' with the card levels' if h.levels is not None else ''}: pose "
                       f"|diff| {diff:.3g}, inliers {n} against {n_cpu}")
        out.append(c)
    return bad, out


def extraction_diff(a: FeatureFrame, b: FeatureFrame) -> dict:
    """Two extractions of one image, keypoint by keypoint (matched by level
    and position, so that a tie broken the other way between two slots
    counts for nothing): whether they have the same keypoints, how many of
    the common ones fall in another angle bin, and, at those in the same
    bin, the keypoints with descriptor bits off, the bits off and the
    largest angle difference in degrees."""
    fa, fb = ({k: v.cpu().numpy() for k, v in f._asdict().items()} for f in (a, b))

    def keyed(f):
        idx = np.nonzero(f["valid"])[0]
        return {(int(f["octave"][i]), *f["xy"][i].tolist()): i for i in idx}

    ka, kb = keyed(fa), keyed(fb)
    common = sorted(set(ka) & set(kb))
    ia = np.array([ka[c] for c in common], int)
    ib = np.array([kb[c] for c in common], int)
    bins = lambda f, i: brief.angle_bins(torch.from_numpy(f["angle"][i])).numpy()
    same = bins(fa, ia) == bins(fb, ib)
    d = np.abs(fa["angle"][ia] - fb["angle"][ib])
    d = np.minimum(d, 360.0 - d)
    bits = np.unpackbits((fa["desc"][ia] ^ fb["desc"][ib]).view(np.uint8), axis=1).sum(1)
    return dict(keypoints_equal=len(common) == len(ka) == len(kb), n_valid=len(ka),
                bins_off=int((~same).sum()), kp_bits_off=int(((bits > 0) & same).sum()),
                bits_off=int(bits[same].sum()),
                max_angle=float(d[same].max()) if same.any() else 0.0)


def _extract_check(img: np.ndarray, ff_card: FeatureFrame, p: OrbParams) -> tuple[list, dict]:
    """An image's extraction on the card against the CPU: the same
    keypoints, or a failure; angle bins, descriptor bits and angles off
    counted (a blurred pixel can round the other way at a .5 tie, a moment
    sum in another order move an angle across a bin's edge)."""
    out = extraction_diff(ff_card, extract(torch.from_numpy(img), p))
    bad = [] if out["keypoints_equal"] else \
        ["card against the CPU: the first image's keypoints differ"]
    return bad, out


# --- A, B: the sweep -------------------------------------------------------------

def _sweep(name: str, stress: bool, device, n_frames: int, min_ok: int) -> dict:
    dev = torch.device(device)
    t0 = time.perf_counter()
    images, centres = sweep_images(stress, n_frames)
    p = orb_params()
    sys_ = system.System(frontend_config(), device=dev)
    first_ff = []

    def step(s, i):
        ff = extract(torch.from_numpy(images[i]).to(dev), p)
        if i == 0:
            first_ff.append(ff)
        s.track_monocular(None, ts=i / 10.0, features=ff)

    d = drive(sys_, n_frames, step, dev)
    rmse, scale, span = _ate(sys_, lambda ts: centres[int(round(ts * 10))])
    n_ok = sum(s == system.OK for s in d.states)
    gates = dict(n_resets=sys_.n_resets, n_ok=n_ok, state=sys_.state, ate=rmse, span=span,
                 ate_ratio=rmse / span, scale=scale)
    bad = []
    if sys_.n_resets != 0:
        bad.append(f"{sys_.n_resets} resets")
    if not n_ok >= min_ok:
        bad.append(f"only {n_ok}/{n_frames} tracked (gate {min_ok})")
    if sys_.state != system.OK:
        bad.append(f"state {sys_.state} at the end")
    if not rmse < 0.08 * span:
        bad.append(f"ATE {rmse:.4f} vs span {span:.3f}")
    check = None
    if dev.type == "cuda":
        cbad, check = _extract_check(images[0], first_ff[0], p)
        bad += cbad
    return _summary(name, sys_, d, gates, bad, t0, extracts=n_frames, card_check=check)


def run_a(device="cuda", n_frames: int = SWEEP_FRAMES) -> dict:
    """A: tests/test_frontend_e2e.py:33.  Gates: no reset, at least 24 of
    36 frames OK, OK at the end, ATE (with scale) below 0.08 of the span."""
    return _sweep("A", False, device, n_frames, 24)


def run_b(device="cuda", n_frames: int = SWEEP_FRAMES) -> dict:
    """B: tests/test_photometric_stress.py:42.  A's gates with at least 22
    frames OK."""
    return _sweep("B", True, device, n_frames, 22)


# --- C: repeatability --------------------------------------------------------------

def repeatability(ff1: FeatureFrame, ff2: FeatureFrame, poses) -> dict:
    """C's numbers from two extractions (on any device): repeatability
    (keypoints within 2 px of the plane transfer), and TH_HIGH matching
    recall (within 2 px) and precision (within 3 px) at ratio 0.9."""
    (R1, t1), (R2, t2) = poses
    v1, v2 = ff1.valid.cpu().numpy(), ff2.valid.cpu().numpy()
    xy1, xy2 = ff1.xy.cpu().numpy()[v1], ff2.xy.cpu().numpy()[v2]
    pred, front = plane_map_xy(xy1, R1, t1, R2, t2)
    h, w = HW
    in_img = front & (pred[:, 0] >= 8) & (pred[:, 0] < w - 8) & (pred[:, 1] >= 8) & \
        (pred[:, 1] < h - 8)
    dists = np.linalg.norm(pred[in_img][:, None] - xy2[None], axis=-1)
    rep = float(np.mean(dists.min(axis=1) < 2.0))
    dev = ff1.desc.device
    sel = torch.from_numpy(np.nonzero(v1)[0][in_img]).to(dev)
    d2 = ff2.desc[ff2.valid]
    mm = matching.match_nn(ff1.desc[sel], d2,
                           mask=torch.ones((len(sel), d2.shape[0]), dtype=torch.bool, device=dev),
                           max_dist=matching.TH_HIGH, nn_ratio=0.9)
    mi, mv = mm.idx.cpu().numpy(), mm.valid.cpu().numpy()
    err = np.linalg.norm(xy2[np.maximum(mi, 0)] - pred[in_img], axis=-1)
    return dict(repeatability=rep,
                recall=float(np.sum(mv & (err < 2.0)) / max(in_img.sum(), 1)),
                precision=float(np.sum(mv & (err < 3.0)) / max(mv.sum(), 1)),
                n_in_view=int(in_img.sum()))


def run_c(device="cuda") -> dict:
    """C: tests/test_photometric_stress.py:105.  Gates: repeatability >=
    0.55, recall >= 0.33, precision >= 0.75."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    img1, img2, *poses = repeatability_images()
    p = orb_params()
    sync = _sync(dev)
    sync()
    te = time.perf_counter()
    ff1 = extract(torch.from_numpy(img1).to(dev), p)
    ff2 = extract(torch.from_numpy(img2).to(dev), p)
    sync()
    ms = (time.perf_counter() - te) / 2 * 1e3
    g = repeatability(ff1, ff2, poses)
    bad = [f"{k} {g[k]:.3f} (gate {v})" for k, v in
           (("repeatability", 0.55), ("recall", 0.33), ("precision", 0.75)) if not g[k] >= v]
    check = None
    if dev.type == "cuda":
        cbad, check = _extract_check(img1, ff1, p)
        bad += cbad
    return dict(name="C", gates=g, bad=bad, extracts=2, kinds={"extraction": (ms, 2)},
                card_check=check, seconds=time.perf_counter() - t0)


# --- D, E: places -------------------------------------------------------------------

def place_scores(images: list, device, lc=None):
    """The keyframe database of the first images (keyframes 0..) and the
    last image's query: (scores of those keyframes, their features)."""
    dev = torch.device(device)
    lc = lc or loop_closing.LoopCloser(loop_closing.LoopConfig(), 16, dev)
    p = orb_params()
    ffs = [extract(torch.from_numpy(img).to(dev), p) for img in images]
    for k, ff in enumerate(ffs[:-1]):
        bow, _ = lc._bow(ff.desc, ff.valid)
        lc.db = kdb.add(lc.db, k, bow)
    bow, _ = lc._bow(ffs[-1].desc, ffs[-1].valid)
    scores, _ = kdb.query(lc.db, bow)
    return scores[:len(images) - 1].cpu().numpy(), ffs


def _places(name: str, unseen: bool, device, margin: float) -> dict:
    dev = torch.device(device)
    t0 = time.perf_counter()
    places, revisit = place_images(unseen)
    lc = loop_closing.LoopCloser(loop_closing.LoopConfig(), 16, dev)
    sync = _sync(dev)
    sync()
    te = time.perf_counter()
    s, ffs = place_scores(places + [revisit], dev, lc)
    sync()
    ms = (time.perf_counter() - te) / 5 * 1e3
    others = np.delete(s, TRUE_PLACE)
    g = dict(scores=s.tolist(), argmax=int(np.argmax(s)),
             margin=float(s[TRUE_PLACE] / others.max()))
    bad = []
    if g["argmax"] != TRUE_PLACE:
        bad.append(f"place {g['argmax']} ranked first, scores {s}")
    if not s[TRUE_PLACE] > margin * others.max():
        bad.append(f"margin {g['margin']:.3f} (gate {margin}), scores {s}")
    check = None
    if dev.type == "cuda":
        cbad, check = _extract_check(places[0], ffs[0], orb_params())
        bad += cbad
    return dict(name=name, gates=g, bad=bad, extracts=5,
                kinds={"extraction + words + query": (ms, 5)}, card_check=check,
                seconds=time.perf_counter() - t0)


def run_d(device="cuda") -> dict:
    """D: tests/test_frontend_e2e.py:81.  Gates: the revisit's place ranked
    first, above 1.15 times the best other score."""
    return _places("D", False, device, 1.15)


def run_e(device="cuda") -> dict:
    """E: tests/test_photometric_stress.py:160.  D's gates with a margin of
    1.10."""
    return _places("E", True, device, 1.10)


# --- F: mono-inertial under IMU noise ----------------------------------------------

def f_configs():
    cfg = system.SlamConfig(cam_params=sw.K4, image_hw=sw.HW, min_init_matches=80,
                            max_frames_between_kf=6, ba_caps=(24, 4096, 16384))
    icfg = inertial_system.InertialConfig(imu_freq=sw.IMU_HZ, init_time_s=1.5,
                                          init_min_kfs=5, use_vi_pose_opt=True)
    return cfg, icfg


def f_inputs(n_frames: int = 120):
    """F's frames (features on the CPU), each frame's noisy IMU samples
    (none before frame 0) and the true position `pos(t)`."""
    world = sw.SyntheticWorld(seed=5)
    frames, pos, _, acc, rot, rot_rate = sw.camera_path_smooth(n_frames)
    rng = np.random.default_rng(7)
    dt_f = 1.0 / sw.FPS
    imu, ffs = [], []
    for i in range(n_frames):
        imu.append(noisy_imu_between((i - 1) * dt_f, i * dt_f, rot, acc, rot_rate, rng)
                   if i > 0 else [])
        ffs.append(world.frame(*frames[i][:2]))
    return ffs, imu, pos


def run_f(device="cuda", n_frames: int = 120, after_imu: int | None = None) -> dict:
    """F: tests/test_inertial_chain.py:141.  Gates: no reset, the IMU
    initialized, and over the second half of the trajectory the Umeyama
    scale within 0.15 of 1 and the RMSE after it below 0.12.  `after_imu`
    ends the drive that many frames after the IMU initialized."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    ffs, imu, pos = f_inputs(n_frames)
    sys_ = inertial_system.InertialSystem(*f_configs(), device=dev)
    imu_frame: list = []

    def step(s, i):
        for sample in imu[i]:
            s.grab_imu(*sample)
        s.track_monocular(None, ts=i / sw.FPS, features=_on(ffs[i], s.device))

    d = drive(sys_, n_frames, step, dev, _stop_after_imu(after_imu, imu_frame),
              keep_copy=dev.type == "cuda")
    rmse, scale, _ = _ate(sys_, pos, half=True)
    gates = dict(n_resets=sys_.n_resets, imu_initialized=sys_.imu_initialized,
                 scale=scale, rmse=rmse, state=sys_.state)
    bad = []
    if sys_.n_resets != 0:
        bad.append(f"{sys_.n_resets} resets")
    if not sys_.imu_initialized:
        bad.append("IMU not initialized")
    if not abs(scale - 1.0) < 0.15:
        bad.append(f"map scale not metric under IMU noise: {scale}")
    if not rmse < 0.12:
        bad.append(f"RMSE {rmse}")
    cbad, checks = _track_check(d, step)
    return _summary("F", sys_, d, gates, bad + cbad, t0, extracts=0,
                    card_check=checks[0] if checks else {},
                    imu_frame=imu_frame[0] if imu_frame else -1,
                    viba1=sys_.viba1_done)


# --- G: stereo-inertial --------------------------------------------------------------

def g_configs():
    cfg = system.SlamConfig(cam_params=sw.K4, image_hw=sw.HW, max_frames_between_kf=6,
                            ba_caps=(24, 4096, 16384), stereo_bf=sw.K4[0] * STEREO_BASELINE)
    icfg = inertial_system.InertialConfig(imu_freq=sw.IMU_HZ, init_time_s=1.2, init_min_kfs=4)
    return cfg, icfg, stereo_system.StereoConfig(baseline=STEREO_BASELINE)


def g_inputs(n_frames: int = 100):
    """G's stereo pairs (features on the CPU), each frame's noiseless IMU
    samples and `pos(t)`."""
    world = StereoWorld(seed=21)
    frames, pos, _, acc, rot, rot_rate = sw.camera_path_smooth(n_frames)
    dt_f = 1.0 / sw.FPS
    imu = [sw.imu_between((i - 1) * dt_f, i * dt_f, rot, acc, rot_rate) if i > 0 else []
           for i in range(n_frames)]
    pairs = [world.stereo_frame(*frames[i][:2], noise_px=0.2) for i in range(n_frames)]
    return pairs, imu, pos


def _stop_after_imu(after_imu: int | None, imu_frame: list) -> Callable:
    """A `drive` stop: records the frame at which the IMU initialized in
    `imu_frame` and ends the drive `after_imu` frames later (never when
    None)."""
    def stop(s, i):
        if s.imu_initialized and not imu_frame:
            imu_frame.append(i)
        return after_imu is not None and bool(imu_frame) and i >= imu_frame[0] + after_imu
    return stop


def run_g(device="cuda", n_frames: int = 100, after_imu: int | None = None) -> dict:
    """G: tests/test_stereo_inertial.py:17.  Gates: no reset, OK at the end,
    the IMU initialized, the RMSE without scale alignment below 0.05, the
    Umeyama scale within 0.02 of 1.  `after_imu` ends the drive that many
    frames after the IMU initialized."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    pairs, imu, pos = g_inputs(n_frames)
    sys_ = stereo_inertial_system.StereoInertialSystem(*g_configs(), device=dev)
    imu_frame: list = []

    def step(s, i):
        for sample in imu[i]:
            s.grab_imu(*sample)
        fl, fr = pairs[i]
        s.track_stereo(None, None, ts=i / sw.FPS, features_l=_on(fl, s.device),
                       features_r=_on(fr, s.device))

    d = drive(sys_, n_frames, step, dev, _stop_after_imu(after_imu, imu_frame),
              keep_copy=dev.type == "cuda")
    rmse, _, _ = _ate(sys_, pos, with_scale=False)
    _, scale, _ = _ate(sys_, pos)
    gates = dict(n_resets=sys_.n_resets, state=sys_.state,
                 imu_initialized=sys_.imu_initialized, rmse=rmse, scale=scale)
    bad = []
    if sys_.n_resets != 0:
        bad.append(f"{sys_.n_resets} resets")
    if sys_.state != system.OK:
        bad.append(f"state {sys_.state} at the end")
    if not sys_.imu_initialized:
        bad.append("IMU not initialized")
    if not rmse < 0.05:
        bad.append(f"RMSE without scale {rmse}")
    if not abs(scale - 1.0) < 0.02:
        bad.append(f"scale {scale}")
    cbad, checks = _track_check(d, step)
    return _summary("G", sys_, d, gates, bad + cbad, t0, extracts=0,
                    card_check=checks[0] if checks else {},
                    imu_frame=imu_frame[0] if imu_frame else -1, viba1=sys_.viba1_done)


# --- H: the ring lap ------------------------------------------------------------------

def h_config():
    return system.SlamConfig(cam_params=sw.K4, image_hw=sw.HW, min_init_matches=80,
                             max_frames_between_kf=6, ba_caps=(24, 4096, 16384),
                             enable_loop_closing=True)


def h_inputs(n_frames: int = 270):
    """H's frames (features on the CPU) and camera centres."""
    world = RingWorld()
    poses = ring_poses(n_frames)
    return [world.frame(R, t) for R, t, _ in poses], [c for *_, c in poses]


def run_h(device="cuda", n_frames: int = 270) -> dict:
    """H: tests/test_long_run.py:47.  Gates: no reset, OK at the end, the
    ATE (with scale) below 0.04.  Also the loops closed (the JAX test
    expects none at this drift)."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    ffs, centres = h_inputs(n_frames)
    sys_ = system.System(h_config(), device=dev)

    def step(s, i):
        s.track_monocular(None, ts=i * 0.05, features=_on(ffs[i], s.device))

    d = drive(sys_, n_frames, step, dev, keep_copy=dev.type == "cuda")
    rmse, scale, _ = _ate(sys_, lambda ts: centres[int(round(ts / 0.05))])
    gates = dict(n_resets=sys_.n_resets, state=sys_.state, ate=rmse, scale=scale,
                 loops=sys_.loop_closer.n_loops_closed)
    bad = []
    if sys_.n_resets != 0:
        bad.append(f"{sys_.n_resets} resets")
    if sys_.state != system.OK:
        bad.append(f"state {sys_.state} at the end")
    if not rmse < 0.04:
        bad.append(f"ATE {rmse}")
    cbad, checks = _track_check(d, step)
    return _summary("H", sys_, d, gates, bad + cbad, t0, extracts=0,
                    card_check=checks[0] if checks else {},
                    last_closure=sys_.loop_closer.last_closure)


# --- I: the monocular synthetic sequence ---------------------------------------------

def i_config():
    return system.SlamConfig(cam_params=sw.K4, image_hw=sw.HW, min_init_matches=80,
                             max_frames_between_kf=8, ba_caps=(24, 4096, 16384))


def i_inputs(n_frames: int = 60):
    """I's frames (features on the CPU) and `camera_path`'s poses."""
    world = sw.SyntheticWorld(seed=1)
    poses = sw.camera_path(n_frames)
    return [world.frame(R, t) for R, t, _ in poses], poses


def run_i(device="cuda", n_frames: int = 60) -> dict:
    """I: tests/test_pipeline_e2e.py:78.  Gates: OK at the end, no reset,
    more than 80% of the frames in the trajectory, the ATE (with scale)
    below 0.05, at least 5 keyframes and more than 300 points."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    ffs, poses = i_inputs(n_frames)
    sys_ = system.System(i_config(), device=dev)

    def step(s, i):
        s.track_monocular(None, ts=i * 0.05, features=_on(ffs[i], s.device))

    d = drive(sys_, n_frames, step, dev, keep_copy=dev.type == "cuda")
    rmse, scale, _ = _ate(sys_, lambda ts: poses[int(round(ts / 0.05))][2])
    n_kf, n_pt = int(sys_.map.n_kf), int(sys_.map.n_pt)
    gates = dict(state=sys_.state, n_resets=sys_.n_resets, n_traj=len(sys_.trajectory),
                 ate=rmse, scale=scale, n_kf=n_kf, n_pt=n_pt)
    bad = []
    if sys_.state != system.OK:
        bad.append(f"state {sys_.state} at the end")
    if sys_.n_resets != 0:
        bad.append(f"{sys_.n_resets} resets")
    if not len(sys_.trajectory) > n_frames * 0.8:
        bad.append(f"{len(sys_.trajectory)} poses of {n_frames} frames")
    if not rmse < 0.05:
        bad.append(f"ATE {rmse}")
    if not n_kf >= 5:
        bad.append(f"{n_kf} keyframes")
    if not n_pt > 300:
        bad.append(f"{n_pt} points")
    cbad, checks = _track_check(d, step)
    return _summary("I", sys_, d, gates, bad + cbad, t0, extracts=0,
                    card_check=checks[0] if checks else {})


# --- J: rectified fisheye stereo-inertial from pixels --------------------------------

J_HW = (384, 384)
J_KB8 = (160.0, 160.0, 192.0, 192.0, 0.0035, 0.0007, -0.002, 0.0002)   # TUM-VI-like
J_BASELINE = 0.2
J_G = np.array([0.0, 0.0, 9.81])         # +z is "down" toward the plane
J_FPS, J_IMU_HZ = 10.0, 200.0
J_FRAMES = 70


def j_rig():
    """(R, t) with x_right = R @ x_left + t: the right camera BASELINE along
    x of the left one, slightly rotated; the rotation through the port's
    float32 `exp_so3` (bit-equal to JAX's here), both in float64."""
    R = lie.exp_so3(torch.tensor([0.004, -0.006, 0.003])).numpy()
    t = -R @ np.array([J_BASELINE, 0.0, 0.0])
    return R.astype(np.float64), t.astype(np.float64)


def j_rectification():
    """`rectify.stereo_rectify(model="kb8")` of J's rig: (map0, map1,
    new_k4, baseline, R1)."""
    R_rel, t_rel = j_rig()
    map0, map1, new_k4, baseline, R1, _ = rectify.stereo_rectify(
        J_KB8[:4], J_KB8[4:], J_KB8[:4], J_KB8[4:], R_rel, t_rel, J_HW, model="kb8")
    return map0, map1, new_k4, baseline, R1


def j_configs(rect=None):
    """J's (SlamConfig, InertialConfig, StereoConfig): the rectified pinhole,
    and Tbc mapping rectified-left coordinates into the body (the raw left
    camera), as `config.tumvi_stereo_inertial` composes it."""
    _, _, new_k4, baseline, R1 = rect or j_rectification()
    cfg = system.SlamConfig(
        cam_model="pinhole", cam_params=tuple(float(v) for v in new_k4), image_hw=J_HW,
        orb=OrbParams(n_features=800, n_levels=8), max_frames_between_kf=6,
        min_init_matches=60, ba_caps=(24, 4096, 16384),
        stereo_bf=float(new_k4[0]) * baseline)
    Tbc = np.eye(4)
    Tbc[:3, :3] = np.asarray(R1, np.float64).T
    icfg = inertial_system.InertialConfig(imu_freq=J_IMU_HZ, init_time_s=1.2, init_min_kfs=4,
                                          Tbc=tuple(Tbc.reshape(-1).tolist()))
    return cfg, icfg, stereo_system.StereoConfig(baseline=baseline)


def j_pos(t: float) -> np.ndarray:
    """The raw left camera's (the body's) centre: a smooth accelerating path
    3 m above the plane."""
    return np.array([0.22 * t + 0.35 * np.sin(0.7 * t), 0.30 * np.sin(1.1 * t),
                     -3.0 + 0.12 * np.sin(0.9 * t)])


def j_acc_w(t: float) -> np.ndarray:
    return np.array([-0.35 * 0.49 * np.sin(0.7 * t), -0.30 * 1.21 * np.sin(1.1 * t),
                     -0.12 * 0.81 * np.sin(0.9 * t)])


def j_world(rng=None):
    """J's texture and its ten shallow mesas (stereo depths 1.8-3.0 m at 3 m
    altitude), drawn from seed 12 in the test's order."""
    rng = np.random.default_rng(12) if rng is None else rng
    tex = sr.block_texture(rng, block=10)
    mesas = tuple((x0, x0 + w, y0, y0 + h, -z) for x0, y0, w, h, z in
                  zip(rng.uniform(-2, 5, 10), rng.uniform(-2, 4, 10), rng.uniform(0.8, 1.6, 10),
                      rng.uniform(0.8, 1.6, 10), rng.uniform(0.4, 1.0, 10)))
    return tex, mesas


def j_imu(i: int) -> list:
    """The samples of (t_{i-1}, t_i] at 200 Hz: gyro 0 (the attitude is
    fixed, the raw left camera is the body), the accelerometer at each
    interval's midpoint."""
    if i == 0:
        return []
    dt_f, dt_i = 1.0 / J_FPS, 1.0 / J_IMU_HZ
    t0, t_frame = (i - 1) * dt_f, i * dt_f
    R_cw = np.eye(3, dtype=np.float64)
    out, k = [], 1
    while t0 + k * dt_i <= t_frame + 1e-9:
        tm = t0 + k * dt_i
        out.append((tm, np.zeros(3), R_cw @ (j_acc_w(tm - 0.5 * dt_i) - J_G)))
        k += 1
    return out


def j_pairs(frames=range(J_FRAMES), rect=None) -> list:
    """The rectified pairs of `frames` (float32, no noise): raw KB8 renders
    of both cameras through `io.euroc.apply_undistort` with the
    rectification maps."""
    map0, map1, *_ = rect or j_rectification()
    tex, mesas = j_world()
    R_rel, t_rel = j_rig()
    rays = sr.kb8_rays(J_KB8, J_HW)
    R_cw = np.eye(3, dtype=np.float64)
    out = []
    for i in frames:
        t_cw_l = -R_cw @ j_pos(i / J_FPS)
        views = ((R_cw, t_cw_l), (R_rel @ R_cw, R_rel @ t_cw_l + t_rel))
        out.append(tuple(
            euroc_io.apply_undistort(sr.render_plane(R, t, J_KB8[:4], J_HW, tex, tex_scale=60.0,
                                                     mesas=mesas, rays=rays), m)
            for (R, t), m in zip(views, (map0, map1))))
    return out


def run_j(device="cuda", n_frames: int = J_FRAMES, after_imu: int | None = None) -> dict:
    """J: tests/test_fisheye_stereo_inertial.py:40.  Gates: no reset, OK at
    the end, the IMU initialized, the RMSE without scale alignment below
    0.08, the Umeyama scale within 0.05 of 1.  `after_imu` ends the drive
    that many frames after the IMU initialized."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    rect = j_rectification()
    pairs = j_pairs(range(n_frames), rect)
    sys_ = stereo_inertial_system.StereoInertialSystem(*j_configs(rect), device=dev)
    first_ff: list = []
    imu_frame: list = []

    def spy(img):
        del sys_._extract     # once: the first left image's features, for the card check
        first_ff.append(sys_._extract(img))
        return first_ff[0]

    sys_._extract = spy

    def step(s, i):
        for sample in j_imu(i):
            s.grab_imu(*sample)
        s.track_stereo(*pairs[i], ts=i / J_FPS)

    # the card check holds the first two tracked frames.  The first one's
    # guess is the stereo initialization's pose, at which every map point was
    # made, so each predicted scale level ceil(log(max_dist / dist) / log 1.2)
    # is taken at an integer, within a float rounding, and the card and the
    # CPU round some of them apart (on an H100 that frame's pose came out
    # 1.3e-3 from the CPU's, with 299 inliers against 298): the CPU runs it
    # with the card's levels too, and the gate reads that run
    d = drive(sys_, n_frames, step, dev, _stop_after_imu(after_imu, imu_frame),
              keep_copy=dev.type == "cuda", hold=2, with_levels=1)
    rmse, _, _ = _ate(sys_, j_pos, with_scale=False)
    _, scale, _ = _ate(sys_, j_pos)
    gates = dict(n_resets=sys_.n_resets, state=sys_.state,
                 imu_initialized=sys_.imu_initialized, rmse=rmse, scale=scale)
    bad = []
    if sys_.n_resets != 0:
        bad.append(f"{sys_.n_resets} resets")
    if sys_.state != system.OK:
        bad.append(f"state {sys_.state} at the end")
    if not sys_.imu_initialized:
        bad.append("IMU not initialized")
    if not rmse < 0.08:
        bad.append(f"RMSE without scale {rmse}")
    if not abs(scale - 1.0) < 0.05:
        bad.append(f"scale {scale}")
    check = None
    if dev.type == "cuda":
        ebad, check = _extract_check(pairs[0][0], first_ff[0], sys_.cfg.orb)
        tbad, tracked = _track_check(d, step)
        bad += ebad + tbad
        check = {**check, "tracked": tracked}
    return _summary("J", sys_, d, gates, bad, t0, extracts=2 * len(d.states), card_check=check,
                    imu_frame=imu_frame[0] if imu_frame else -1, viba1=sys_.viba1_done)


SCENARIOS = {"A": run_a, "B": run_b, "C": run_c, "D": run_d, "E": run_e, "F": run_f,
             "G": run_g, "H": run_h, "I": run_i, "J": run_j}


def system_to(sys_, device) -> system.System:
    """A copy of a System of any kind on `device`: every tensor of its state
    (and of its loop closer, Atlas and IMU bookkeeping) moved, its stereo
    matchers rebuilt for the copy, its generator's state (a System draws on
    the CPU) and no side stream.
    Used to run one step of a card's System again on the CPU."""
    device = torch.device(device)
    memo: dict = {}

    def moved(v):
        if id(v) in memo:
            return memo[id(v)]
        if isinstance(v, torch.Tensor):
            out = v.to(device)
        elif isinstance(v, torch.device):
            out = device
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            out = type(v)(*(moved(x) for x in v))
        elif isinstance(v, (list, tuple)):
            out = type(v)(moved(x) for x in v)
        elif isinstance(v, dict):
            out = {k: moved(x) for k, x in v.items()}
        elif type(v).__module__.startswith("orbslam3_tpu_torch") and hasattr(v, "__dict__") \
                and not (dataclasses.is_dataclass(v) and v.__dataclass_params__.frozen):
            out = copy.copy(v)
            memo[id(v)] = out
            for k, x in vars(v).items():
                object.__setattr__(out, k, moved(x))
        else:
            out = v
        memo[id(v)] = out
        return out

    out = copy.copy(sys_)
    for k, v in vars(sys_).items():
        if callable(v) and not isinstance(v, torch.Tensor):
            continue
        setattr(out, k, moved(v))
    out.device = device
    out.generator = torch.Generator()       # the same draws from here on
    out.generator.set_state(sys_.generator.get_state())
    out._side_stream = None
    if isinstance(out, (stereo_system.StereoSystem, stereo_inertial_system.StereoInertialSystem)):
        stereo_system.StereoSystem._build_stereo_matchers(out, out.cfg, out.scfg)
    return out


def main(argv=None) -> int:
    """`python -m orbslam3_tpu_torch.utils.acceptance [LETTER ...] [--device
    cuda|cpu]`: each scenario (all by default) uncut, on the first card
    unless `--device cpu`; one JSON line per scenario (its gates, the drive,
    the card check, `orb_describe`'s launches).  Exits 1 if a gate failed."""
    import argparse
    import json
    from ..ops import orb_patches
    from ..tools import add_device_arg, device_name, device_of
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.utils.acceptance")
    ap.add_argument("letters", nargs="*", default=list(SCENARIOS), choices=list(SCENARIOS))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args.device)
    print(f"device: {device_name(dev)}", flush=True)
    bad = False
    for name in args.letters:
        orb_patches.reset_counters()
        r = SCENARIOS[name](dev)
        r["launches"] = orb_patches.launch_counts()
        r.pop("last_closure", None)
        bad |= bool(r["bad"])
        print(f"{name}: {json.dumps(r, default=str)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
