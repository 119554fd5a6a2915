"""The multi-session Atlas and GNSS georeferencing on bench.py's scene, with
ground truth: two drives of `seeded_scene.drive_system` over bench.py's 78
frames at the scene's configuration.

  * `drive_merge`: frames 30-33 are textureless (a uniform gray image: no
    FAST corner), and relocalization is switched off on the instance, as
    `tests/test_map_merge.py:22-26` does, so that the occlusion resets the
    map into the Atlas instead of relocalizing it.  The second map starts
    where the first ended; the path moves 0.03 units a frame at a height of
    5 over a view 9.4 units wide, so the second map's keyframes see the
    ground of the first's last keyframes, and with `enable_loop_closing`
    the second map's first inserted keyframe welds it into the first
    (`map_merging.try_merge`).
  * `drive_gnss`: every frame is preceded by a GNSS fix, the true camera
    centre mapped into a geo frame (scale 7, 0.8 rad about z, offset
    (4.5e6, 1.1e6, 320): `tests/test_gnss.py`'s) with N(0, 0.02) noise from
    a seeded numpy generator, under that test's GNSS settings.

`two_sessions` builds a small merge scene straight into a `System`, in the
manner of `utils/loop_scene.py`: `tests/test_map_merge.py`'s two sessions
of one place seen from a rigid offset.

NumPy and torch only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import lie
from ..pipeline import system
from ..slam_map import atlas as atlas_mod
from . import loop_scene
from . import seeded_scene as scene

BLANK = (30, 31, 32, 33)           # the occlusion of `drive_merge`
GEO_SCALE, GEO_YAW = 7.0, 0.8
GEO_OFFSET = (4.5e6, 1.1e6, 320.0)
GNSS_NOISE, GNSS_SEED = 0.02, 2
GNSS = dict(enable_gnss=True, gnss_min_kfs=6, gnss_ba_every=2, gnss_sigma=0.05,
            gnss_time_tol=0.03)


def merge_frames(cfg: scene.SceneConfig, frames: dict) -> dict:
    """The frames with those of BLANK replaced by a uniform gray image."""
    gray = np.full(cfg.hw, 128, np.uint8)
    return {fi: gray if fi in BLANK else img for fi, img in frames.items()}


def drive_merge(cfg: scene.SceneConfig, frames: dict, device, wrap=None, **overrides):
    """`drive_system` over `merge_frames` with `enable_loop_closing` and no
    relocalization on a loss (the loss resets the map into the Atlas).
    Returns (System, SystemDrive)."""
    sys_ = system.System(dataclasses.replace(scene.system_config(cfg), enable_loop_closing=True,
                                             **overrides), device=device)
    sys_._handle_tracking_loss = lambda ff: False
    return scene.drive_system(cfg, merge_frames(cfg, frames), device, sys_=sys_, wrap=wrap)


def check_merge_gates(sys_: system.System, d: scene.SystemDrive, min_cover: float = 0.7,
                      max_ate_ratio: float = 0.08) -> tuple[list[str], dict]:
    """Gate failures of a `drive_merge` run (empty = passed) and its numbers:
    at least one reset and the stored session consumed; OK on every frame
    from the merge on; at least 2 valid keyframes of each session in the
    merged map; a merged trajectory over more than `min_cover` of the frames
    with an ATE below `max_ate_ratio` of the path's span; the merge edge
    (welded keyframe, candidate) persisted."""
    bad = []
    lm = sys_.last_merge
    if sys_.n_resets < 1 or lm is None or sys_.atlas.n_maps:
        return [f"{sys_.n_resets} resets, merge {lm}, {sys_.atlas.n_maps} stored maps"], {}
    n = len(d.frames)
    # the merging frame: the keyframe count jumps by the archived keyframes
    # (an initialization starts from 0)
    merge_at = next(i for i in range(1, n) if 2 <= d.n_kf[i - 1] < d.n_kf[i] - 1)
    lost = [d.frames[i] for i in range(merge_at, n) if d.states[i] != system.OK]
    if lost:
        bad.append(f"not OK on frames {lost} after the merge")
    nk, off = sys_.n_kf_host, lm["kf_off"]
    valid = sys_.map.kf_valid[:nk].cpu().numpy()
    per_session = (int(valid[:off].sum()), int(valid[off:].sum()))
    if min(per_session) < 2:
        bad.append(f"valid keyframes per session {per_session}")
    if len(sys_.trajectory) <= min_cover * n:
        bad.append(f"trajectory of {len(sys_.trajectory)} frames of {n}")
    rmse, scale, span = scene.system_ate(sys_)
    if not rmse < max_ate_ratio * span:
        bad.append(f"ATE {rmse:.4g} of a span of {span:.4g}")
    nl = int(sys_.map.n_loop)
    edges = list(zip(sys_.map.loop_i[:nl].tolist(), sys_.map.loop_j[:nl].tolist()))
    weld = lm["kf"] + off
    if (weld, lm["cand"]) not in edges:
        bad.append(f"merge edge {(weld, lm['cand'])} not in {edges}")
    reset_at = next(d.frames[i] for i in range(n) if d.states[i] == system.NO_IMAGES_YET)
    return bad, dict(merge_frame=d.frames[merge_at], reset_frame=reset_at,
                     merge={k: lm[k] for k in ("session", "kf", "cand", "n_matches",
                                               "n_inliers", "kf_off", "pt_off")},
                     scale_sim3=lm["s"], n_kf=nk, per_session=per_session,
                     n_traj=len(sys_.trajectory), ate=rmse, scale=scale, span=span,
                     n_points=int(sys_.map.pt_valid.sum()))


def geo_track(indices) -> dict:
    """{frame: true camera centre in the geo frame} (float64)."""
    c, s_ = np.cos(GEO_YAW), np.sin(GEO_YAW)
    R = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
    out = {}
    for i in indices:
        R_cw, t_cw = scene.bench_pose(i)
        centre = -R_cw.T.astype(np.float64) @ t_cw.astype(np.float64)
        out[i] = GEO_SCALE * (R @ centre) + np.asarray(GEO_OFFSET)
    return out


def drive_gnss(cfg: scene.SceneConfig, frames: dict, device, wrap=None, **overrides):
    """`drive_system` with the GNSS settings, a noisy fix of the true geo
    track before every frame.  Returns (System, SystemDrive, geo track)."""
    gt = geo_track(cfg.track_frames)
    rng = np.random.default_rng(GNSS_SEED)
    fixes = {i: gt[i] + rng.normal(0, GNSS_NOISE, 3) for i in cfg.track_frames}
    sys_, d = scene.drive_system(
        cfg, frames, device, before=lambda fi, s_: s_.grab_gnss(fi / 10.0, fixes[fi]),
        wrap=wrap, **{**GNSS, **overrides})
    return sys_, d, gt


def check_gnss_gates(sys_: system.System, d: scene.SystemDrive, gt: dict,
                     max_rmse: float = 0.5) -> tuple[list[str], dict]:
    """Gate failures of a `drive_gnss` run (empty = passed) and its numbers:
    the georeference initialized; at least one GNSS BA posted, and every one
    merged or still pending; no reset; every keyframe pose and trajectory
    entry finite; the geo-frame trajectory within an RMSE of `max_rmse` of
    the true geo track."""
    bad = []
    if not sys_.georef.initialized:
        return ["the georeference never initialized"], {}
    c = sys_.chain_counts
    merged = c["merged gba at a poll"] + c["merged gba forced"]
    pending = sys_._pending is not None
    if sys_.n_gnss_ba < 1 or merged < 1 or merged + pending != c["posted gba"] or \
            c["posted gba"] != sys_.n_gnss_ba:
        bad.append(f"{sys_.n_gnss_ba} GNSS BAs, chains {dict(c)}")
    if sys_.n_resets or sys_.n_map_switches:
        bad.append(f"{sys_.n_resets} resets, {sys_.n_map_switches} map switches")
    nk = sys_.n_kf_host
    finite = bool(torch.isfinite(sys_.map.kf_R[:nk]).all()) and \
        bool(torch.isfinite(sys_.map.kf_t[:nk]).all()) and \
        all(np.isfinite(p[2]).all() for p in sys_.trajectory)
    if not finite:
        bad.append("a pose is not finite")
    geo = sys_.trajectory_geo()
    ref = np.stack([gt[int(round(p[0] * 10.0))] for p in sys_.trajectory])
    rmse = float(np.sqrt(np.mean(np.sum((geo - ref) ** 2, axis=1))))
    if not rmse < max_rmse:
        bad.append(f"geo RMSE {rmse:.4g}")
    T = sys_.georef.transform
    return bad, dict(n_gnss_ba=sys_.n_gnss_ba, merged=merged, pending=pending,
                     geo_rmse=rmse, geo_scale=float(T.s), n_kf=nk,
                     n_fixes=len(sys_.kf_gnss), n_traj=len(sys_.trajectory))


def two_sessions(sys_: system.System, n_kp: int = 256, seed: int = 2):
    """Write TestInertialMerge's scene into `sys_` (an empty System with a
    `LoopCloser`, at loop_scene's camera): an archived session whose
    keyframe 0 sees 200 landmarks of one place from the origin, with its
    keyframe database, and a current map whose keyframes 0 and 1 see 50 and
    all 200 of them from a rigid offset (rotation 0.25 rad about z, translation
    (1, -0.5, 0.3)), as new points; the tracker at keyframe 1.  Returns
    keyframe 1's features."""
    rng = np.random.default_rng(seed)
    X0, desc0 = loop_scene.place(rng, 200)
    eye = np.eye(3, dtype=np.float32)
    old = system.System(sys_.cfg, device=sys_.device)
    _, _, ff0 = loop_scene.add_keyframe(old, 0, X0, desc0, eye, np.zeros(3), 30.0, n_kp)
    old.loop_closer.add_keyframe(old.map, 0, ff0)
    sys_.atlas.sessions.append(atlas_mod.MapSession(
        map=old.map, bank=old.bank, trajectory=[(0.0, np.eye(3), np.zeros(3))],
        db=old.loop_closer.db))
    Rz = lie.exp_so3(torch.tensor([0.0, 0.0, 0.25])).numpy()
    dtv = np.array([1.0, -0.5, 0.3], np.float32)
    X_cur = (X0 @ Rz.T + dtv).astype(np.float32)
    R_cur, t_cur = Rz.T, -Rz.T @ dtv
    uv0 = loop_scene.project(X0, eye, np.zeros(3, np.float32))
    loop_scene.add_keyframe(sys_, 0, X_cur[:50], desc0[:50], R_cur, t_cur, 30.0, n_kp,
                            uv=uv0[:50])
    _, _, ff1 = loop_scene.add_keyframe(sys_, 1, X_cur, desc0, R_cur, t_cur, 30.0, n_kp, uv=uv0)
    sys_._set_pose(sys_.map.kf_R[1], sys_.map.kf_t[1])
    sys_.R_prev, sys_.t_prev = sys_.R_cur, sys_.t_cur
    sys_.last_kf_idx = 1
    sys_.state = system.OK
    return ff1
