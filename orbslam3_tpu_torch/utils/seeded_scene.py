"""Monocular drives on bench.py's scene, with ground truth: the per-frame
and keyframe steps on a map seeded from ground-truth poses, the whole
`System` from raw frames (`drive_system`), and that `System` losing its track
and recovering by relocalization (`drive_relocalization`, at the end of this
file).

The scene is `bench.py`'s (`bench_full_system`, bench.py:99-119): a
textured ground plane seen from 5 units above along a gently weaving
trajectory (frame i at t = i/10), rendered with sensor noise of sigma 1.5.
Every pixel's depth is the plane's, which lets the seeded drives build
their map without two-view initialization:

  * each seed keyframe is extracted and appended with its ground-truth
    pose (`add_keyframe`);
  * the first one's valid keypoints are back-projected onto z = 0 and
    become the map points (`add_points`, `point_descriptor_stats` for
    normal and scale range), observed by their keypoints;
  * every later seed keyframe binds its keypoints to those points with
    `fusion.fuse_into_keyframe` (projection and descriptor match), so a
    point has one slot however many keyframes see it and the keypoints
    left unbound are what the keyframe step triangulates;
  * each seed keyframe's FeatureBank row holds its keypoints and these
    bindings; points seen by fewer than two keyframes are invalidated;
  * the local view is `gather_local_view` around the last seed keyframe;
  * the tracked frames then run `frame_step.track_frame`, starting from
    the ground-truth velocity, and each tracked pose is held against the
    ground truth;
  * `track_with_keyframes` also runs the synchronous keyframe step after
    every `kf_every`-th tracked frame (bench.py's cadence, bench.py:121,166):
    `system.kf_step`, `kf_pose_refresh` and `post_ba_stages`, as
    `System._insert_keyframe` does (system.py:849-927).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..features.extractor import OrbParams, extract
from ..ops import cameras, lie
from ..pipeline import frame_step, fusion, mapping, system
from . import align
from ..slam_map import feature_bank as fb
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
    # keyframe step: bench.py's cadence and the SlamConfig mapping fields
    kf_every: int = 6
    new_pt_budget: int = 768
    ba_caps: tuple = (16, 4096, 12288)
    # gate on every keyframe step: median |z| of its new points (the scene
    # is the z = 0 plane seen from 5 units up).  Six frames apart, a
    # keyframe and its temporal neighbour see a point under ~2 degrees of
    # parallax, and 0.5 px of keypoint noise is then ~0.15 units of depth;
    # the JAX package's own drive at this size gives medians of 0.110-0.154
    # after the step's BA.  The gate (5% of the depth) leaves room for that.
    max_new_pt_z: float = 0.25


def slam_config(cfg: SceneConfig) -> system.SlamConfig:
    """The SlamConfig of the scene (defaults elsewhere)."""
    return system.SlamConfig(
        cam_model="pinhole", cam_params=cfg.K4, image_hw=cfg.hw, orb=cfg.orb,
        map_capacity=cfg.capacity, local_view_points=cfg.view_points,
        local_view_kfs=cfg.view_kfs, max_frames_between_kf=cfg.kf_every,
        new_pt_budget=cfg.new_pt_budget, ba_caps=cfg.ba_caps)


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
    """Seed the map and the feature bank from the ground-truth keyframes;
    returns (map, bank, view)."""
    p = cfg.orb
    cam = torch.tensor(cfg.K4, dtype=torch.float32, device=device)
    m = mapstate.empty_map(cfg.capacity, device)
    bank = None
    for k, fi in enumerate(cfg.seed_frames):
        R, t = _pose_on(fi, device)
        ff = extract(torch.from_numpy(frames[fi]).to(device), p)
        m, ki = mapstate.add_keyframe(m, R, t, fi / 10.0, fi)
        if bank is None:
            bank = fb.empty_bank(cfg.capacity.n_kf, ff.capacity, device)
        if k == 0:
            Rwc, twc = lie.se3_inverse(R, t)
            d = cameras.pinhole_unproject(cam, ff.xy) @ Rwc.T
            X = twc + (-twc[2] / d[:, 2])[:, None] * d      # onto z = 0
            normal, min_d, max_d = mapping.point_descriptor_stats(
                X, ff.desc, twc, ff.octave, p.scale_factor, p.n_levels)
            m, kp_pt = mapstate.add_points(m, X, ff.desc, normal, min_d, max_d,
                                           ki, fi, ff.valid)
            m = mapstate.add_observations(m, ki, kp_pt, ff.xy, ff.octave, ff.valid)
        else:
            m, kp_pt, _ = fusion.fuse_into_keyframe(
                m, ki, ff, torch.full_like(ff.octave, -1), "pinhole", cam,
                cfg.hw, p.scale_factor, p.n_levels)
        bank = fb.set_frame(bank, ki, ff, kp_pt)
    # a map point needs two observing keyframes
    m = m._replace(pt_valid=m.pt_valid & (mapstate.point_obs_count(m) >= 2))
    view = mapstate.gather_local_view(m, len(cfg.seed_frames) - 1,
                                      cfg.view_points, window=cfg.view_kfs)
    return m, bank, view


def _sync_fn(device):
    """Synchronise for `device` (None: the default, a CUDA device)."""
    on_card = device is None or torch.device(device).type == "cuda"
    return torch.cuda.synchronize if on_card else (lambda: None)


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
    sync = _sync_fn(device)
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


class KfStep(NamedTuple):
    """One keyframe step of `track_with_keyframes`, read back after it."""
    ki: int
    frame: int
    n_new: int
    new_pt_z: float           # median |z| of the step's new points
    kf_poses: list            # (frame id, R_cw, t_cw) of every valid KF
    seconds: float


def track_with_keyframes(cfg: SceneConfig, m, bank, view, frames: dict, device):
    """Track cfg.track_frames and run the keyframe step after every
    `kf_every`-th of them, with the view the step returns used for the
    frames that follow.  Returns (map, bank, view, list of (frame, R_cw,
    t_cw, n_inliers), per-frame seconds, list of KfStep).  A step's time
    is the host clock from `kf_step` to a synchronise after
    `post_ba_stages`; what the gates read is read back after that."""
    p = cfg.orb
    scfg = slam_config(cfg)
    cam = torch.tensor(cfg.K4, dtype=torch.float32, device=device)
    f0 = cfg.track_frames[0]
    R_prev, t_prev = _pose_on(f0 - 2, device)
    R_cur, t_cur = _pose_on(f0 - 1, device)
    imgs = {i: torch.from_numpy(frames[i]).to(device) for i in cfg.track_frames}
    kp_ur = torch.full((bank.xy.shape[1],), -1.0, dtype=torch.float32, device=device)
    ki = len(cfg.seed_frames)
    sync = _sync_fn(device)
    sync()
    out, secs, steps = [], [], []
    for n, fi in enumerate(cfg.track_frames, 1):
        t0 = time.perf_counter()
        m, ff, R, t, kp_pt, n_inl = frame_step.track_frame(
            m, view, imgs[fi], R_prev, t_prev, R_cur, t_cur, p, cam, cfg.hw,
            radius_th=cfg.radius_th)
        sync()
        secs.append(time.perf_counter() - t0)
        out.append((fi, R, t, n_inl))
        R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
        if n % cfg.kf_every or ki >= cfg.capacity.n_kf - 1:
            continue
        t0 = time.perf_counter()
        m, bank, _, kp_new, n_new, view = system.kf_step(
            scfg, cam, m, bank, ff, kp_pt, R, t, fi / 10.0, fi, kp_ur, ki)
        R_prev, t_prev, R_cur, t_cur = system.kf_pose_refresh(
            m, ki, R_cur, t_cur, R_prev, t_prev)
        m, bank, _, view, _ = system.post_ba_stages(scfg, cam, m, bank, ki, ff,
                                                 kp_new, view)
        sync()
        dt = time.perf_counter() - t0
        created = kp_new[(kp_pt < 0) & (kp_new >= 0)].long()
        z = torch.abs(m.pt_xyz[created, 2])
        n_kf = int(m.n_kf)
        valid = m.kf_valid[:n_kf].cpu().numpy()
        kf_poses = [(int(f), R_.numpy(), t_.numpy()) for f, R_, t_, v in zip(
            m.kf_frame_id[:n_kf].cpu(), m.kf_R[:n_kf].cpu(), m.kf_t[:n_kf].cpu(),
            valid) if v]
        steps.append(KfStep(ki, fi, int(n_new),
                            float(torch.median(z)) if z.numel() else float("nan"),
                            kf_poses, dt))
        ki += 1
    return m, bank, view, [(fi, R.cpu().numpy(), t.cpu().numpy(), int(n))
                           for fi, R, t, n in out], secs, steps


def check_kf_gates(cfg: SceneConfig, steps) -> list[str]:
    """Keyframe-step gate failures (empty = every step passed): new points
    were made, their median |z| is within `max_new_pt_z` of the plane, and
    every valid keyframe pose is within the tracking pose gates."""
    bad = []
    for s in steps:
        if not (s.n_new > 0 and s.new_pt_z <= cfg.max_new_pt_z):
            bad.append(f"KF {s.ki} (frame {s.frame}): {s.n_new} new points, "
                       f"median |z| {s.new_pt_z:.4g}")
        for f, R, t in s.kf_poses:
            dc, dr = pose_errors(R, t, f)
            if not (dc <= cfg.max_center_err and dr <= cfg.max_rot_err_deg):
                bad.append(f"after KF {s.ki}: KF of frame {f} centre err "
                           f"{dc:.4g}, rot err {dr:.4g} deg")
    return bad


def first_kf_inputs(cfg: SceneConfig, m, view, frames: dict, device):
    """Track the first `kf_every` frames; returns (map, FeatureFrame, kp_pt,
    R_cw, t_cw, frame) of the last, the inputs of the first keyframe step."""
    p = cfg.orb
    cam = torch.tensor(cfg.K4, dtype=torch.float32, device=device)
    f0 = cfg.track_frames[0]
    R_prev, t_prev = _pose_on(f0 - 2, device)
    R_cur, t_cur = _pose_on(f0 - 1, device)
    for fi in cfg.track_frames[:cfg.kf_every]:
        m, ff, R, t, kp_pt, _ = frame_step.track_frame(
            m, view, torch.from_numpy(frames[fi]).to(device), R_prev, t_prev,
            R_cur, t_cur, p, cam, cfg.hw, radius_th=cfg.radius_th)
        R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
    return m, ff, kp_pt, R, t, fi


def kf_step_mismatch(ref, got, kp_in, pose_tol: float = 1e-4,
                     pt_rel_tol: float = 1e-3) -> tuple[list[str], dict]:
    """Differences between two `system.kf_step` outputs (on any devices)
    from the same inputs, `kp_in` being the new keyframe's bindings before
    the step.  Returns (failures, empty if they agree; the measured max
    pose |diff|, max point relative diff and number of relabelled slots).

    The new points must come from the same keypoints of the new keyframe
    and fill the same set of slots; `n_new`, the new keyframe's bindings,
    the bank's bindings and the valid points must then be equal, keyframe
    poses within `pose_tol` and valid points within `pt_rel_tol` of
    max(|X|, 1).  The slots are handed out in the order of the new points'
    parallax scores, and scores that differ in the last float bit between
    two devices can swap two near-tied points, so `got`'s new slots are
    first relabelled to `ref`'s through the keypoint that created each."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        return type(x)(*map(host, x)) if hasattr(x, "_fields") else x

    m_r, bank_r, _, kp_r, n_r, _ = map(host, ref)
    m_g, bank_g, _, kp_g, n_g, _ = map(host, got)
    kp_in = kp_in.cpu()
    bad = []
    stats = dict(pose=float("nan"), point=float("nan"), relabelled=0)
    if int(n_r) != int(n_g):
        bad.append(f"n_new {int(n_g)} != {int(n_r)}")
    made_r, made_g = (kp_in < 0) & (kp_r >= 0), (kp_in < 0) & (kp_g >= 0)
    if not torch.equal(made_r, made_g):
        return bad + ["new points come from other keypoints"], stats
    slots_r, slots_g = kp_r[made_r].long(), kp_g[made_g].long()
    if not torch.equal(torch.sort(slots_r).values, torch.sort(slots_g).values):
        return bad + ["new points fill other slots"], stats
    stats["relabelled"] = int((slots_r != slots_g).sum())
    P = m_g.pt_xyz.shape[0]
    relabel = torch.arange(P, dtype=torch.int32)
    relabel[slots_g] = slots_r.to(torch.int32)

    def binds(kp):
        return torch.where(kp >= 0, relabel[torch.clamp_min(kp, 0).long()], kp)

    def points(x):
        out = x.clone()
        out[relabel.long()] = x
        return out

    if not torch.equal(kp_r, binds(kp_g)):
        bad.append("new keypoint bindings differ")
    if not torch.equal(bank_r.kp_pt, binds(bank_g.kp_pt)):
        bad.append("bank bindings differ")
    valid = m_r.pt_valid
    if not torch.equal(valid, points(m_g.pt_valid)):
        bad.append("valid points differ")
    stats["pose"] = 0.0
    for name in ("kf_R", "kf_t"):
        d = float((getattr(m_r, name) - getattr(m_g, name)).abs().max())
        stats["pose"] = max(stats["pose"], d)
        if not d <= pose_tol:
            bad.append(f"{name} max |diff| {d:.3g} > {pose_tol}")
    Xr, Xg = m_r.pt_xyz[valid], points(m_g.pt_xyz)[valid]
    rel = (torch.linalg.norm(Xr - Xg, dim=1) /
           torch.clamp_min(torch.linalg.norm(Xr, dim=1), 1.0))
    stats["point"] = float(rel.max()) if rel.numel() else 0.0
    if not stats["point"] <= pt_rel_tol:
        bad.append(f"points max relative diff {stats['point']:.3g} > {pt_rel_tol}")
    return bad, stats


# --- the whole System from raw frames ---------------------------------------

def system_config(cfg: SceneConfig) -> system.SlamConfig:
    """bench.py's `System` configuration (bench.py:103-107) at the scene's
    sizes: `min_init_matches=60`, `min_track_inliers=20`,
    `max_frames_between_kf=6`, everything else the scene's or the default."""
    return dataclasses.replace(slam_config(cfg), min_init_matches=60,
                               min_track_inliers=20)


class SystemDrive(NamedTuple):
    """What `drive_system` saw, frame by frame (lists over the frames fed)."""
    frames: list       # frame index
    states: list       # tracking state after the frame
    seconds: list      # host clock around `track_monocular` up to a synchronise
    inliers: list      # inliers of a tracked frame, None where none was tracked
    n_kf: list         # keyframes in the map after the frame
    init_frame: int    # position in `frames` of the initialising frame, -1 if none


def drive_system(cfg: SceneConfig, frames: dict, device, seed: int = 42, **overrides):
    """Feed cfg.track_frames, as uint8 images with ts = i / 10, to a fresh
    `System` through `track_monocular` and nothing else (`device` None: the
    System's default, the card); `overrides` replace fields of its
    `system_config` (async_mapping, enable_loop_closing, ...).  Returns
    (System, SystemDrive)."""
    sys_ = system.System(dataclasses.replace(system_config(cfg), **overrides), device=device,
                         seed=seed)
    sync = _sync_fn(device)
    d = SystemDrive([], [], [], [], [], -1)
    init_frame = -1
    for n, fi in enumerate(cfg.track_frames):
        was = sys_.state
        sync()
        t0 = time.perf_counter()
        state, _ = sys_.track_monocular(frames[fi], fi / 10.0)
        sync()
        d.seconds.append(time.perf_counter() - t0)
        d.frames.append(fi)
        d.states.append(state)
        tracked = was in (system.OK, system.RECENTLY_LOST)
        d.inliers.append(sys_.last_track_inliers if tracked else None)
        d.n_kf.append(sys_.n_kf_host)
        if init_frame < 0 and was != system.OK and state == system.OK:
            init_frame = n
    return sys_, d._replace(init_frame=init_frame)


def system_ate(sys_: system.System):
    """ATE RMSE of the system's trajectory against the ground-truth camera
    centres after Umeyama alignment with scale: (rmse, scale, span of the
    ground-truth path over the trajectory's frames)."""
    est = np.stack([p[2] for p in sys_.trajectory])
    gt = []
    for ts, _, _ in sys_.trajectory:
        R, t = bench_pose(int(round(ts * 10.0)))
        gt.append(-R.T.astype(np.float64) @ t.astype(np.float64))
    gt = np.stack(gt)
    rmse, s, _, _ = align.ate_rmse(est, gt)
    return rmse, s, float(np.linalg.norm(gt.max(0) - gt.min(0)))


def check_system_gates(sys_: system.System, d: SystemDrive,
                       init_by: int = 29, max_ate_ratio: float = 0.08,
                       min_points: int = 200) -> tuple[list[str], dict]:
    """Gate failures of a `drive_system` run (empty = passed) and its
    numbers: initialised no later than position `init_by`, OK on every frame
    after, no reset and no map switch, every tracked frame with at least
    `min_track_inliers` inliers, keyframes inserted by the system's own
    decision, more than `min_points` valid map points, and an ATE RMSE below
    `max_ate_ratio` of the ground-truth path's span."""
    scfg = sys_.cfg
    bad = []
    n = len(d.frames)
    if not 0 <= d.init_frame <= init_by:
        return [f"not initialised by frame {init_by} (states {d.states})"], {}
    lost = [d.frames[i] for i in range(d.init_frame, n) if d.states[i] != system.OK]
    if lost:
        bad.append(f"not OK on frames {lost}")
    if sys_.n_resets or sys_.n_map_switches:
        bad.append(f"{sys_.n_resets} resets, {sys_.n_map_switches} map switches")
    inl = [x for x in d.inliers[d.init_frame + 1:] if x is not None]
    if not inl or min(inl) < scfg.min_track_inliers:
        bad.append(f"tracked-frame inliers {inl}")
    n_kf_made = d.n_kf[-1] - 2
    need_kf = (n - d.init_frame) // scfg.max_frames_between_kf - 1
    if n_kf_made < need_kf:
        bad.append(f"{n_kf_made} keyframes inserted, {need_kf} expected")
    n_pts = int(sys_.map.pt_valid.sum())
    if n_pts <= min_points:
        bad.append(f"{n_pts} valid map points")
    rmse, scale, span = system_ate(sys_)
    if not rmse < max_ate_ratio * span:
        bad.append(f"ATE {rmse:.4g} of a span of {span:.4g}")
    kf_frame = [i > d.init_frame and d.n_kf[i] > d.n_kf[i - 1] for i in range(n)]
    plain = [d.seconds[i] for i in range(d.init_frame + 1, n) if not kf_frame[i]]
    kf_secs = [d.seconds[i] for i in range(n) if kf_frame[i]]
    stats = dict(
        init_frame=d.frames[d.init_frame], init=dict(sys_.init_info),
        init_ms=d.seconds[d.init_frame] * 1e3,
        frame_ms=float(np.median(plain)) * 1e3 if plain else float("nan"),
        kf_frame_ms=float(np.median(kf_secs)) * 1e3 if kf_secs else float("nan"),
        n_tracked=len(plain), n_kf_frames=len(kf_secs),
        inliers=(min(inl), max(inl)) if inl else None, n_kf=d.n_kf[-1],
        n_points=n_pts, ate=rmse, scale=scale, span=span)
    return bad, stats


# --- a lost System recovers by relocalization -----------------------------------

class RelocDrive(NamedTuple):
    """What `drive_relocalization` saw."""
    blank_states: list     # state after each textureless frame
    blank_poses: list      # pose returned for each (None when nothing was recovered)
    frames: list           # the revisited frame indices
    states: list           # state after each revisited frame
    inliers: list          # local-map tracking inliers of each revisited frame
    seconds: list          # host clock around `track_monocular` up to a synchronise
    centre_err: float      # recovered camera centre against the first visit's, world units
    rot_err_deg: float     # recovered rotation against the first visit's
    recovered: int         # position in `frames` of the first OK frame, -1 if none


N_BLANK = 3                  # textureless frames before the revisit
REVISIT_NOISE_SEED = 1234    # the revisited frames' sensor noise


def render_revisit(cfg: SceneConfig, indices) -> dict[int, np.ndarray]:
    """Frames `indices` of the scene rendered again with fresh sensor noise
    (the texture is `render_frames`': the generator's first draw)."""
    tex = sr.block_texture(np.random.default_rng(cfg.seed), block=cfg.tex_block)
    rng = np.random.default_rng(REVISIT_NOISE_SEED)
    frames = {}
    for i in indices:
        R_cw, t_cw = bench_pose(i)
        img = sr.render_plane(R_cw, t_cw, np.asarray(cfg.K4), cfg.hw, tex,
                              tex_scale=cfg.tex_scale)
        img += rng.normal(0, cfg.noise_sigma, img.shape).astype(np.float32)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def drive_relocalization(sys_: system.System, cfg: SceneConfig, revisit, device):
    """After `drive_system`: feed `N_BLANK` textureless frames (the track is
    lost, nothing to recognise), then frames `revisit` of the scene, seen
    much earlier on the path, rendered with fresh noise; timestamps go on
    from the last frame's at 0.1 s a frame.  Everything goes through
    `track_monocular`.  Returns a RelocDrive; the pose errors compare the
    first recovered frame with the pose the system itself recorded for that
    frame index the first time, the centre distance scaled to world units by
    the trajectory's Umeyama scale."""
    sync = _sync_fn(device)
    _, scale, _ = system_ate(sys_)
    first = {int(round(ts * 10.0)): (R, t) for ts, R, t in sys_.trajectory}
    ts = sys_._prev_frame_ts
    gray = np.full(cfg.hw, 128, np.uint8)
    d = RelocDrive([], [], list(revisit), [], [], [], float("nan"), float("nan"), -1)
    for _ in range(N_BLANK):
        ts += 0.1
        state, pose = sys_.track_monocular(gray, ts)
        d.blank_states.append(state)
        d.blank_poses.append(pose)
    imgs = render_revisit(cfg, revisit)
    recovered, dc, dr = -1, float("nan"), float("nan")
    for n, fi in enumerate(revisit):
        ts += 0.1
        sync()
        t0 = time.perf_counter()
        state, pose = sys_.track_monocular(imgs[fi], ts)
        sync()
        d.seconds.append(time.perf_counter() - t0)
        d.states.append(state)
        d.inliers.append(sys_.last_track_inliers)
        if recovered < 0 and state == system.OK:
            recovered = n
            R0, c0 = first[fi]
            dc = float(np.linalg.norm(pose[1] - c0)) * scale
            cos = (np.trace(pose[0] @ R0.T) - 1.0) / 2.0
            dr = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return d._replace(centre_err=dc, rot_err_deg=dr, recovered=recovered)


def check_reloc_gates(sys_: system.System, d: RelocDrive, n_maps_before: int,
                      max_center_err: float = 0.05, max_rot_err_deg: float = 0.5) -> list[str]:
    """Gate failures of a `drive_relocalization` run (empty = passed): the
    textureless frames leave the state RECENTLY_LOST and recover nothing; the
    first revisited frame or the next is OK, through relocalization (its own
    local-map tracking had fewer than `min_track_inliers` inliers); no reset
    and no new map; the recovered pose within the bounds of the first visit's;
    every later frame OK with at least `min_track_inliers` inliers."""
    bad = []
    min_inl = sys_.cfg.min_track_inliers
    if any(s != system.RECENTLY_LOST for s in d.blank_states) or \
            any(p is not None for p in d.blank_poses):
        bad.append(f"textureless frames: states {d.blank_states}")
    if d.recovered not in (0, 1):
        return bad + [f"not recovered on the first two revisited frames (states {d.states})"]
    if not d.inliers[d.recovered] < min_inl:
        bad.append(f"frame {d.frames[d.recovered]} was tracked from the last pose "
                   f"({d.inliers[d.recovered]} inliers), not relocalized")
    if sys_.n_resets or sys_.n_map_switches or sys_.atlas.n_maps != n_maps_before:
        bad.append(f"{sys_.n_resets} resets, {sys_.n_map_switches} map switches, "
                   f"{sys_.atlas.n_maps} stored maps")
    if not (d.centre_err <= max_center_err and d.rot_err_deg <= max_rot_err_deg):
        bad.append(f"recovered pose off by {d.centre_err:.4g} units, {d.rot_err_deg:.4g} deg")
    after = range(d.recovered + 1, len(d.frames))
    if any(d.states[i] != system.OK or d.inliers[i] < min_inl for i in after):
        bad.append(f"after the recovery: states {d.states}, inliers {d.inliers}")
    return bad
