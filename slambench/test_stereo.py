"""The harness with a stereo-inertial configuration, on the CPU.

    python -m pytest slambench/test_stereo.py -q

No configuration file or cell uses a pair yet: `pair_spec` builds one in
memory, the port's `tumvi_stereo_inertial` preset (the TUM-VI 512x512 pair
rectified to a virtual pinhole, the BMI160 IMU at 200 Hz) on a pair over the
plane (`sequences/plane_pair.py`), driven by `systems/stereo_inertial.py`.
The tests hold the stereo association's reference against the port's, show
that `stereo_wrong` fails a moved right u and a dropped octave gate, that
`Capture` keeps both extractions of a pair and knows the tracked one, that
`preset_checked` takes the stereo presets, that `judge` reads the
monocular and inertial captures as it did before pairs, and drive the spec
through a whole run.
"""

from __future__ import annotations

import copy
import types

import numpy as np
import pytest
import torch

from slambench import checks, optimum, reference, run, scene, systems, trace
from slambench.sequences import plane_pair

torch.set_num_threads(4)

PAIR_PATH = {"x": {"v": 0.3, "glide": [2.1, 2.0]}, "y": {"sin": [[0.05, 1.7, 0.0]]},
             "height": {"c": 2.5, "sin": [[0.2, 1.2, 0.0]]}, "yaw": {"sin": [[0.04, 1.0, 0.0]]},
             "tilt": {"sin": [[0.03, 1.3, 0.0]]}}


def pair_spec(scale: float = 1.0, frames: int = 600, overrides: dict | None = None) -> dict:
    """A stereo-inertial cell's spec (`run.load_cell`'s dict) in memory:
    the `tumvi_stereo_inertial` preset's numbers as it states them, at
    `scale` of its image size with the preset `overrides` that give it."""
    from orbslam3_tpu_torch import config as presets
    cfg, icfg, scfg = presets.tumvi_stereo_inertial()[:3]
    K = [float(v) * scale for v in cfg.cam_params]
    orb = dict(n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels,
               scale_factor=cfg.orb.scale_factor, ini_th_fast=cfg.orb.ini_th_fast,
               min_th_fast=cfg.orb.min_th_fast)
    num = dict(cam_params=K, image_hw=[int(round(h * scale)) for h in cfg.image_hw], orb=orb,
               max_frames_between_kf=cfg.max_frames_between_kf,
               imu=dict(imu_freq=icfg.imu_freq, noise_gyro=icfg.noise_gyro,
                        noise_acc=icfg.noise_acc, walk_gyro=icfg.walk_gyro,
                        walk_acc=icfg.walk_acc, Tbc=list(icfg.Tbc),
                        init_time_s=icfg.init_time_s, init_min_kfs=icfg.init_min_kfs),
               stereo=dict(baseline=scfg.baseline, stereo_bf=K[0] * scfg.baseline,
                           max_depth_factor=scfg.max_depth_factor))
    config = dict(name="tumvi_stereo_inertial", system="stereo_inertial",
                  preset="tumvi_stereo_inertial", preset_numbers=num,
                  checks={"desc_wrong": 0.05, "stereo_wrong": 0.0, "ate_share": 0.08,
                          "scale_err": 0.15})
    traffic = dict(generator="plane_pair", camera_hz=20, imu_hz=200, frames=frames,
                   pixel_noise=1.0, texture=dict(size=1024, block=10, tex_scale=80.0 * scale),
                   path=copy.deepcopy(PAIR_PATH),
                   warmup=dict(min_frames=40, min_keyframes=6, until="viba1_done",
                               max_frames=400),
                   check=dict(frames=3, from_first=6),
                   trace=dict(min_frames=4, min_keyframes=0, max_frames=4, extract_frames=3))
    for k, v in (overrides or {}).items():
        if k == "orb":
            num["orb"].update(n_features=v.n_features, n_levels=v.n_levels)
        elif k in ("cam_params", "image_hw"):
            num[k] = list(v)
        elif k == "stereo_bf":
            num["stereo"]["stereo_bf"] = v
        else:
            num[k] = v
    return dict(cell=dict(name="tumvi_stereo_inertial.flight", config=config["name"],
                          traffic="pair_pass", chips=1),
                config=config, traffic=traffic,
                end_to_end=[dict(name="fps", unit="frames/s"), dict(name="setup_s", unit="s")],
                per_layer=[])


def small_pair_spec(frames: int = 120) -> tuple[dict, dict]:
    """The pair at 256x256 with 500 features over 4 levels, a keyframe at
    least every 5 frames, warmed up to the IMU initialization; and the
    preset overrides that give it."""
    from orbslam3_tpu_torch.features.extractor import OrbParams
    from orbslam3_tpu_torch import config as presets
    cfg, _, scfg = presets.tumvi_stereo_inertial()[:3]
    K = tuple(float(v) / 2 for v in cfg.cam_params)
    ov = dict(image_hw=(256, 256), cam_params=K, orb=OrbParams(n_features=500, n_levels=4),
              max_frames_between_kf=5, stereo_bf=K[0] * scfg.baseline)
    spec = pair_spec(0.5, frames, ov)
    spec["traffic"]["warmup"].update(until="imu_initialized", min_keyframes=6)
    spec["traffic"]["check"] = dict(frames=2, from_first=4)
    return spec, ov


# ------------------------------------------------- the association's reference
def _pair_frame(seed: int = 2 ** 31 + 99):
    """A small pair over the plane, both images extracted by the port."""
    from orbslam3_tpu_torch.features import extractor
    from orbslam3_tpu_torch.features.extractor import OrbParams
    spec, _ = small_pair_spec()
    num = spec["config"]["preset_numbers"]
    seq = plane_pair.make(dict(spec["traffic"], frames=2), spec["config"], seed, "cpu")
    p = OrbParams(n_features=600, n_levels=4)
    il, ir = torch.from_numpy(seq.frames[1]), torch.from_numpy(seq.right[1])
    return seq, num, il, ir, extractor.extract(il, p), extractor.extract(ir, p)


def _as_pair(ff_l, ff_r, d, out) -> dict:
    vl, vr = ff_l.valid.numpy(), ff_r.valid.numpy()
    return dict(xy_l=ff_l.xy.numpy()[vl], oct_l=ff_l.octave.numpy()[vl],
                desc_l=ff_l.desc.numpy()[vl], xy_r=ff_r.xy.numpy()[vr],
                oct_r=ff_r.octave.numpy()[vr], desc_r=ff_r.desc.numpy()[vr],
                ur_matched=d.ur.numpy()[vl], valid=out.valid.numpy()[vl], ur=out.ur.numpy()[vl],
                depth=out.depth.numpy()[vl])


def _associate(match, il, ir, ff_l, ff_r, fx, b):
    from orbslam3_tpu_torch.features import stereo
    # the stereo Systems' call (`stereo_system._build_stereo_matchers`)
    d = match(ff_l, ff_r, fx, b, max_depth=35.0 * b * 3)
    out = stereo.refine_disparity(il.float(), ir.float(), ff_l.xy, d, fx, b)
    return _as_pair(ff_l, ff_r, d, out)


def _gates(num) -> dict:
    st = num["stereo"]
    return reference.stereo_gates(st["baseline"], st["max_depth_factor"], num["orb"]["scale_factor"])


def test_stereo_reference_agrees_with_the_ports_association():
    from orbslam3_tpu_torch.features import stereo
    seq, num, il, ir, ff_l, ff_r = _pair_frame()
    fx, b = num["cam_params"][0], num["stereo"]["baseline"]
    got = reference.check_stereo(_associate(stereo.stereo_match, il, ir, ff_l, ff_r, fx, b),
                                 seq.frames[1], seq.right[1], fx, b, _gates(num))
    assert got["wrong"] == 0.0 and got["n"] == 600 and got["n_assoc"] > 300, got
    assert got["ur_gap_px"] < 1e-4 and got["depth_rel_gap"] < 1e-5, got


def _no_octave_gate(ff_l, ff_r, fx, baseline, row_tol=2.0, min_depth=0.1, max_depth=40.0,
                    scale_factor=1.2):
    """`stereo_match` without its octave gate."""
    from orbslam3_tpu_torch.features import stereo
    from orbslam3_tpu_torch.ops import matching
    du = ff_l.xy[:, None, 0] - ff_r.xy[None, :, 0]
    dv = torch.abs(ff_l.xy[:, None, 1] - ff_r.xy[None, :, 1])
    tol = row_tol * scale_factor ** ff_l.octave.to(torch.float32)
    mask = (dv <= tol[:, None]) & (du >= fx * baseline / max_depth) & \
        (du <= fx * baseline / min_depth) & ff_l.valid[:, None] & ff_r.valid[None, :]
    mm = matching.match_nn(ff_l.desc, ff_r.desc, mask, max_dist=matching.TH_HIGH, nn_ratio=0.9)
    ur = ff_r.xy[torch.clamp_min(mm.idx, 0).long(), 0]
    depth = fx * baseline / torch.clamp_min(ff_l.xy[:, 0] - ur, 1e-3)
    ok = mm.valid & (depth > min_depth) & (depth < max_depth)
    return stereo.StereoDepth(ur=torch.where(ok, ur, -1.0), depth=torch.where(ok, depth, 0.0),
                              valid=ok)


def moved_right_u(ur: np.ndarray, valid: np.ndarray, share: float = 0.05) -> np.ndarray:
    """`ur` with 1 px added on `share` of the keypoints, spread over the
    associated ones (an unassociated keypoint's right u is no answer)."""
    assoc = np.flatnonzero(valid)
    k = int(np.ceil(share * valid.shape[0]))
    out = np.array(ur, copy=True)
    out[assoc[np.linspace(0, assoc.size - 1, k).astype(np.int64)]] += 1.0
    return out


@pytest.mark.parametrize("fault", ["right_u_moved", "octave_gate_dropped"])
def test_stereo_wrong_fails_a_broken_association(fault):
    """A right u moved 1 px on 5% of the left keypoints (associated ones)
    reads 0.05 or more;
    the octave gate dropped changes 1-3% of the associations on this scene
    (0.8-1.8% of 600 keypoints on three frames at this size), which sound
    associations never do."""
    from orbslam3_tpu_torch.features import stereo
    seq, num, il, ir, ff_l, ff_r = _pair_frame()
    fx, b = num["cam_params"][0], num["stereo"]["baseline"]
    match = _no_octave_gate if fault == "octave_gate_dropped" else stereo.stereo_match
    pair = _associate(match, il, ir, ff_l, ff_r, fx, b)
    if fault == "right_u_moved":
        pair["ur"] = moved_right_u(pair["ur"], pair["valid"])
    got = reference.check_stereo(pair, seq.frames[1], seq.right[1], fx, b, _gates(num))
    assert got["wrong"] >= (0.05 if fault == "right_u_moved" else 0.005), got


# ------------------------------------------------------ capture and presets
def test_capture_keeps_both_extractions_and_marks_the_left_one():
    from slambench.systems import stereo_inertial
    spec, ov = small_pair_spec(frames=3)
    seq = plane_pair.make(spec["traffic"], spec["config"], 5, "cpu")
    sys_ = stereo_inertial.build(spec["config"], torch.device("cpu"), 5, ov)
    ranges = trace.Ranges()
    cap = run.Capture(sys_)
    try:
        cap.install(ranges)
        cap.ff_frames = {1, 2}
        for i in range(3):
            stereo_inertial.feed(sys_, seq, i)
    finally:
        ranges.restore()
    assert set(cap.ff) == {1, 2} and set(cap.stereo) == {1, 2}
    for i in (1, 2):
        (left, ff_l), (right, ff_r) = cap.ff[i]
        assert np.array_equal(left.numpy(), seq.frames[i])
        assert np.array_equal(right.numpy(), seq.right[i])
        assert cap.tracked(i) is ff_l and cap.stereo[i]["match"][0]["ff_l"] is ff_l
        assert cap.stereo[i]["match"][0]["ff_r"] is ff_r
        assert set(cap.stereo[i]) == {"match", "refine"}


@pytest.mark.parametrize("preset", ["tumvi_stereo_inertial", "euroc_stereo_inertial",
                                    "euroc_stereo", "euroc_stereo_rectified", "euroc_rgbd"])
def test_preset_checked_takes_the_stereo_presets(preset):
    from orbslam3_tpu_torch import config as presets
    from orbslam3_tpu_torch.pipeline import inertial_system
    out = getattr(presets, preset)()
    cfg, scfg = out[0], out[2 if isinstance(out[1], inertial_system.InertialConfig) else 1]
    num = dict(cam_params=list(cfg.cam_params), image_hw=list(cfg.image_hw),
               orb=dict(n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels),
               max_frames_between_kf=cfg.max_frames_between_kf,
               stereo=dict(baseline=scfg.baseline, stereo_bf=cfg.stereo_bf,
                           max_depth_factor=scfg.max_depth_factor))
    inertial = "inertial" in preset
    if inertial:
        icfg = out[1]
        num["imu"] = {k: getattr(icfg, k) for k in (
            "imu_freq", "noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "init_time_s",
            "init_min_kfs")} | dict(Tbc=list(icfg.Tbc))
    got = systems.preset_checked(dict(preset=preset, preset_numbers=num), {})
    # the whole return goes back to the system module
    assert len(got) == len(out) and all(
        (g == o).all() if isinstance(o, np.ndarray) else g == o for g, o in zip(got, out))
    for key, moved in (("baseline", scfg.baseline * 1.01), ("stereo_bf", cfg.stereo_bf + 0.1),
                       ("max_depth_factor", scfg.max_depth_factor + 1.0)):
        bad = copy.deepcopy(num)
        bad["stereo"][key] = moved
        with pytest.raises(RuntimeError, match=key):
            systems.preset_checked(dict(preset=preset, preset_numbers=bad), {})
    if inertial:
        # the Tbc stated must be the one composed with the rectifying rotation
        raw = copy.deepcopy(num)
        raw["imu"]["Tbc"] = list(np.eye(4).ravel())
        with pytest.raises(RuntimeError, match="Tbc"):
            systems.preset_checked(dict(preset=preset, preset_numbers=raw), {})


# ------------------------------------------------- judge on fixed captures
def _packed(bits: np.ndarray) -> np.ndarray:
    """(n, 256) bool -> (n, 8) int32 words, bit b of word w = pair 32w + b."""
    w = (bits.reshape(-1, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return w.astype(np.uint32).view(np.int32)


def _fixed_features(rng, img: np.ndarray, n: int = 60) -> dict:
    """Keypoints on three levels of `img` with the reference's own
    descriptors, one bit flipped in every tenth."""
    raw, blur = reference.pyramid(img, 3, 1.2)
    octave = rng.integers(0, 3, n)
    xy = np.zeros((n, 2))
    desc = np.zeros((n, 8), np.int32)
    for lv in range(3):
        sel = np.flatnonzero(octave == lv)
        h, w = raw[lv].shape
        k = np.stack([rng.integers(20, w - 20, sel.size), rng.integers(20, h - 20, sel.size)], 1)
        xy[sel] = k * 1.2 ** lv
        bits = reference.descriptors(blur[lv], k, reference.angle_bins(
            reference.ic_angles(raw[lv], k)))
        desc[sel] = _packed(bits)
    desc[::10, 1] ^= 1 << 3
    return dict(image=img, xy=xy.astype(np.float32), octave=octave, desc=desc)


def fixed_capture(inertial: bool):
    """A capture made from the seed in NumPy alone, as `checks.collect`
    returns it, with its sequence and configuration: two sampled frames'
    features, a tracked frame's pose-only optimization (flight) or both VI
    pose optimizations and an inertial-only initialization (inertial), a
    window BA, the returned trajectory and new points."""
    cell = "euroc_mono_inertial.flight" if inertial else "euroc_mono.flight"
    config = run.load_cell(cell)["config"]
    num = config["preset_numbers"]
    K4 = num["cam_params"]
    rng = np.random.default_rng(11)
    path = scene.Path(PAIR_PATH)
    n = 40
    seq = types.SimpleNamespace(ts=[i / 20 for i in range(n)], path=path)
    seq.centers = np.stack([path.center(t) for t in seq.ts])
    seq.frames = rng.integers(0, 256, (n, 96, 128)).astype(np.uint8)
    feats = {i: [_fixed_features(rng, seq.frames[i])] for i in (3, 5)}
    idx = np.arange(2, 30)
    est_R = np.stack([path.pose64(seq.ts[i])[0] for i in idx])
    produced = dict(feats=feats, pairs={}, tracks={}, bas=[], vis=[], inits=[],
                    new_points=np.c_[rng.uniform(0, 4, (50, 2)), rng.normal(0, 0.01, 50)] * 0.7,
                    est_index=idx, est_R=est_R,
                    est_center=(seq.centers[idx] + rng.normal(0, 0.01, (idx.size, 3))) * 0.7)
    # a window BA of five cameras, returned a little off its optimum
    Rs = np.stack([optimum.exp_so3(rng.normal(0, 0.05, 3)) for _ in range(5)])
    ts = -np.einsum("kab,kb->ka", Rs, np.stack([[0.3 * k, 0.02 * k, 0.0] for k in range(5)]))
    X = rng.uniform([-1.5, -1, 3], [2.5, 1, 5], (80, 3))
    uv = optimum.project(K4, np.einsum("kab,pb->pka", Rs, X) + ts[None]) + \
        rng.normal(0, 1.0, (80, 5, 2))
    pad = lambda a, fill=0: np.concatenate(  # noqa: E731
        [a, np.full((a.shape[0], 11) + a.shape[2:], fill, a.dtype)], 1)
    R16, t16 = pad(Rs[None])[0], pad(ts[None])[0]
    produced["bas"].append(dict(
        frame=12, R=R16, t=t16, X=X, fixed=np.arange(16) == 0, cam_valid=np.arange(16) < 5,
        pt_valid=np.ones(80, bool), uv=pad(uv), inv_s2=pad(np.ones((80, 5)), 1.0),
        valid=pad(rng.uniform(size=(80, 5)) < 0.9, False),
        out=dict(R=R16, t=t16 + 1e-3, X=X + rng.normal(0, 1e-3, X.shape))))
    if not inertial:
        R0, t0 = optimum.exp_so3([0.004, -0.003, 0.002]), np.array([0.01, -0.02, 0.015])
        Xp = rng.uniform([-2, -1.5, 2], [2, 1.5, 4], (120, 3))
        octave = rng.integers(0, 8, 120)
        uvp = reference.project(K4, Xp) + rng.normal(0, 1.0, (120, 2))
        valid = rng.uniform(size=120) < 0.95
        R, t, inl = reference.pose_schedule(R0, t0, Xp, uvp, octave, valid, K4, 1.2)
        produced["tracks"][5] = dict(R0=R0, t0=t0, X=Xp, uv=uvp, valid=valid, octave=octave,
                                     R=R, t=t + 1e-4, inliers=inl)
        return produced, seq, config
    imu = num["imu"]
    Tbc = np.asarray(imu["Tbc"], np.float64).reshape(4, 4)
    seq.imu = scene.imu_samples(path, Tbc, 200.0, 20.0, n, imu, rng)
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]

    def body(t):
        Rwc, pwc = path.pose64(t)
        return Rwc @ Rbc.T, pwc - Rwc @ Rbc.T @ tbc

    def vel(t, h=1e-4):
        return (body(t + h)[1] - body(t - h)[1]) / (2 * h)

    for kind, frame in (("lastkf", 20), ("lastframe", 21)):
        t1 = seq.ts[frame]
        Rwb, pwb = body(t1)
        Rwc, pwc = Rwb @ Rbc, pwb + Rwb @ tbc
        uv0 = rng.uniform([20, 20], [730, 460], (100, 2))
        depth = rng.uniform(3, 6, 100)
        Xw = np.c_[(uv0 - K4[2:]) / K4[:2] * depth[:, None], depth] @ Rwc.T + pwc
        octave = rng.integers(0, 4, 100)
        start = (Rwb @ optimum.exp_so3([0.01, -0.01, 0.005]), pwb + [0.03, -0.02, 0.01],
                 vel(t1) + [0.05, 0.0, -0.05], np.zeros(6))
        call = dict(frame=frame, kind=kind, t1=t1, bias0=np.zeros(6), R0=start[0], p0=start[1],
                    v0=start[2], b0=start[3], X=Xw,
                    uv=uv0 + rng.normal(0, 1.0, (100, 2)) * 1.2 ** octave[:, None],
                    octave=octave, out=dict(R=Rwb, p=pwb + 1e-3, v=vel(t1), b=np.zeros(6)))
        if kind == "lastkf":
            t0 = seq.ts[frame - 5]
            call.update(t0=t0, kf=(*body(t0), vel(t0), np.zeros(6)))
        else:
            t0 = seq.ts[frame - 1]
            call.update(t0=t0, prior=dict(R=body(t0)[0], p=body(t0)[1], v=vel(t0), b=np.zeros(6),
                                          H=np.diag([1e4] * 6 + [1e3] * 3 + [1e5] * 6)))
        produced["vis"].append(call)
    kts = [seq.ts[i] for i in range(2, 34, 4)]
    produced["inits"].append(dict(
        Rwb=np.stack([body(t)[0] for t in kts]), pwb=np.stack([body(t)[1] for t in kts]) * 0.5,
        pairs=[(i, i + 1) for i in range(7)], times=list(zip(kts[:-1], kts[1:])),
        b0=np.zeros((7, 6)), prior_g=1e2, prior_a=1e6, fix_scale=False,
        out=dict(scale=2.05, Rwg=optimum.exp_so3([0.01, 0.0, 0.0]), bias=np.zeros(6),
                 vel=np.stack([vel(t) for t in kts]) * 0.5)))
    produced["imu_initialized"] = True
    return produced, seq, config


# What the parent's `judge` (before pairs: one extraction a frame, held
# against `seq.frames[i]`) read on these captures
PARENT_JUDGE = {
    False: {"desc_wrong": 0.1, "pose_gap_px": 0.05088328965689628, "ba_undone": 1.0649254922658367,
            "ate_share": 0.0074052781328883, "pose_opt_gap_px": 0.05088328965702268,
            "scale_err": 0.4259140425154031, "tilt_deg": 0.0, "map_height": 0.0032015624453076786,
            "ba_gap_px": 2.846720372005121},
    True: {"desc_wrong": 0.1, "vi_undone": 0.008880335337625615, "init_undone": 1.1020772900313314,
           "ate_share": 0.0074052781328883, "scale_err": 0.4259140425154031, "tilt_deg": 0.0,
           "map_height": 0.0032015624453076786, "ba_undone": 1.0649254922658367,
           "ba_gap_px": 2.846720372005121, "vi_gap_px": 0.7430530118939475,
           "vi_undone.lastkf": 0.0023457244344980348, "vi_undone.lastframe": 0.008880335337625615,
           "init_gravity_deg": 0.5423900507206694, "init_scale_gap": 0.019748175604410667,
           "init_vel_gap": 0.5025766967629334, "init_bias_gap": 0.0005381684802116595},
}


@pytest.mark.parametrize("inertial", [False, True])
def test_judge_reads_fixed_captures_as_before_pairs(inertial):
    produced, seq, config = fixed_capture(inertial)
    verdict = checks.judge(produced, seq, config)
    values = {k: c["value"] for k, c in verdict["checks"].items()} | {
        k: v for k, v in verdict["readings"].items() if not k.endswith("_each")}
    assert values == pytest.approx(PARENT_JUDGE[inertial], rel=1e-9, abs=1e-15), values


# ------------------------------------------------------------- a whole run
def test_a_stereo_inertial_spec_runs_through_warm_up_window_and_judge_on_the_cpu():
    spec, ov = small_pair_spec()
    out = run.run_cell(spec, 2 ** 31 + 4321, 2.0, False, device="cpu", overrides=ov)
    checked = out["checks"]
    assert checked["stereo_wrong"]["value"] == 0.0, checked
    assert checked["desc_wrong"]["value"] <= 0.05 and checked["ate_share"]["value"] <= 0.08, \
        checked
    assert out["notes"]["init"]["imu"] and out["failed"] == 0, out["notes"]
    assert out["notes"]["readings"]["stereo_ur_gap_px"] < 1e-3
    assert set(out["metrics"]) == {"fps", "setup_s"} and list(out)[-1] == "checks"
