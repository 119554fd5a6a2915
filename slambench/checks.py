"""What decides `correct`, and the check that JAX stayed out of the process.

`collect` copies to the host what the timed path produced (the window's
returned poses, the sampled frames' keypoints and descriptors, their
tracking correspondences, the map's points made in the window, the IMU
state) so that the System can be freed before the reference runs.  `judge`
holds each number named in the configuration's `checks` against its limit
there; a number that cannot be read fails.  The numbers that a
configuration does not compare are returned as readings.

  desc_wrong    share of an extraction's keypoints whose descriptor differs
                from the reference's in any bit, worked out from the image
                that extraction was given (largest over every extraction of
                the sampled frames: both images of a pair)
  pose_gap_px   largest shift of a returned inlier's projection between a
                sampled tracked frame's pose-only optimization and the same
                schedule worked out in float64 from its start and
                correspondences (largest over the frames); beside it, as a
                reading, the gap to the least-squares optimum of the inliers
                it returned (`pose_opt_gap_px`)
  ate_share     RMSE of the window's returned camera centres after the best
                similarity to the true path, over the path's span
  scale_err     |s - 1| of that similarity (a metric map after the IMU init)
  tilt_deg      how far the map's vertical lies from the true gravity's (the
                rotation that best maps the returned camera orientations
                onto the true ones)
  map_height    median distance of the map points made in the window, moved
                by that rotation and the scale and offset that then fit the
                centres, to the true scene surface, over the camera's mean
                height
  ba_undone     share of the work left undone by a window BA of the keyframe
                step in the window (`optimum.check_ba`; the largest over up
                to `keyframe_steps` of them drawn from the seed among the
                window's first `keyframes_from_first` frames)
  vi_undone     the same of the VI pose optimizations of the window's first
                `from_first` frames (`optimum.check_vi_pose`)
  init_undone   the same of each inertial-only initialization in set-up (the
                IMU initialization and VIBA1, `optimum.check_imu_init`), with
                its gravity, scale, velocity and bias gaps as readings
  stereo_wrong  share of a sampled pair's valid left keypoints whose
                association (valid or not, the right keypoint matched) or
                refined right u (beyond 1e-3 px) differs from the
                reference's, worked out from the two rendered images and the
                keypoints extracted from them (`reference.check_stereo`;
                largest over the frames), with the largest right-u gap
                (`stereo_ur_gap_px`) and relative depth gap
                (`stereo_depth_rel_gap`) of the keypoints associated alike as
                readings

The pose-only optimization, the VI pose optimizations and the pair's
association read the features that tracking used (`Capture.tracked`).
"""

from __future__ import annotations

import sys

import numpy as np

from . import optimum
from . import reference as ref
from . import scene

JAX_NAMES = ("jax", "jaxlib", "flax", "orbslam3_tpu")


def loaded_jax(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, each module's
    top-level name (the part before the first dot) compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(JAX_NAMES))


def _np(x):
    return x.detach().cpu().numpy()


def _state(R, p, v, b) -> tuple:
    return tuple(_np(x).astype(np.float64) for x in (R, p, v, b))


def _pair(cap, i: int) -> dict:
    """A pair's association and refinement in frame i, over the valid left
    keypoints, with the keypoints of both images (the reference works its
    gates out from the configuration, not from the program's call)."""
    calls = cap.stereo[i]
    if "refine" not in calls:
        raise RuntimeError(f"frame {i}: a pair associated without its refinement")
    (a, d), (_, out) = calls["match"], calls["refine"]
    ff_l, ff_r = a["ff_l"], a["ff_r"]
    if ff_l is not cap.tracked(i):
        raise RuntimeError(f"frame {i}: the association's left features are not the tracker's")
    vl, vr = _np(ff_l.valid), _np(ff_r.valid)
    return dict(xy_l=_np(ff_l.xy)[vl], oct_l=_np(ff_l.octave)[vl], desc_l=_np(ff_l.desc)[vl],
                xy_r=_np(ff_r.xy)[vr], oct_r=_np(ff_r.octave)[vr], desc_r=_np(ff_r.desc)[vr],
                ur_matched=_np(d.ur)[vl], valid=_np(out.valid)[vl], ur=_np(out.ur)[vl],
                depth=_np(out.depth)[vl])


def collect(sys_, cap, seq, log, poses, i0: int, seed: int, chk: dict) -> dict:
    picks = sorted(cap.ff_frames & {f.index for f in log})
    feats = {}
    for i in picks:
        for image, ff in cap.ff.get(i, ()):
            v = _np(ff.valid)
            feats.setdefault(i, []).append(dict(image=_np(image), xy=_np(ff.xy)[v],
                                                octave=_np(ff.octave)[v], desc=_np(ff.desc)[v]))
    pairs = {i: _pair(cap, i) for i in picks if i in cap.stereo}
    tracks = {}
    for i, (R0, t0, X, uv, valid, res) in cap.track.items():
        tracks[i] = dict(R0=_np(R0), t0=_np(t0), X=_np(X), uv=_np(uv), valid=_np(valid),
                         octave=_np(cap.tracked(i).octave), R=_np(res.R), t=_np(res.t),
                         inliers=_np(res.inliers))
    # the window BAs, drawn from the seed
    rng = np.random.default_rng((seed + 1) % (2 ** 63))
    n_ba = min(len(cap.ba), chk.get("keyframe_steps", 0))
    bas = []
    for k in sorted(rng.choice(len(cap.ba), n_ba, replace=False)) if n_ba else ():
        frame, prob, (R, t, X, _) = cap.ba[k]
        bas.append(dict(frame=frame, R=_np(prob.R), t=_np(prob.t), X=_np(prob.X),
                        fixed=_np(prob.cam_fixed), cam_valid=_np(prob.cam_valid),
                        pt_valid=_np(prob.pt_valid), uv=_np(prob.uv), inv_s2=_np(prob.inv_sigma2),
                        valid=_np(prob.valid), out=dict(R=_np(R), t=_np(t), X=_np(X))))
    vis = []
    for c in cap.vi:
        a = c["args"]
        i = c["frame"]
        if c["kind"] == "lastkf":
            (R0, p0, v0, b0, Rk, pk, vk, bk, _f, X, uv, _s, valid) = a[:13]
            extra = dict(kf=_state(Rk, pk, vk, bk), t0=float(c["kf_ts"]))
            res = c["out"]
        else:
            (R0, p0, v0, b0, prior, _f, X, uv, _s, valid) = a[:10]
            extra = dict(prior=dict(zip(("R", "p", "v", "b"), _state(*prior[:4])),
                                    H=_np(prior.H).astype(np.float64)), t0=seq.ts[i - 1])
            res = c["out"][0]
        inl = _np(res.inliers)
        ff = cap.tracked(i)
        vis.append(dict(
            frame=i, kind=c["kind"], t1=seq.ts[i], bias0=_np(b0).astype(np.float64),
            R0=_np(R0).astype(np.float64), p0=_np(p0).astype(np.float64),
            v0=_np(v0).astype(np.float64), b0=_np(b0).astype(np.float64),
            X=_np(X)[inl].astype(np.float64), uv=_np(uv)[inl].astype(np.float64),
            octave=_np(ff.octave)[inl],
            out=dict(zip(("R", "p", "v", "b"), _state(res.Rwb, res.pwb, res.vel, res.bias))),
            **extra))
    inits = []
    for c in cap.init:
        f, Rwb, pwb = c["args"][:3]
        kw = dict(c["kwargs"])
        kf_ts = _np(c["kf_ts"]).astype(np.float64)
        res = c["out"]
        inits.append(dict(
            Rwb=_np(Rwb).astype(np.float64), pwb=_np(pwb).astype(np.float64),
            pairs=list(zip(_np(f.kf_i).tolist(), _np(f.kf_j).tolist())),
            times=[(float(kf_ts[i]), float(kf_ts[j])) for i, j in c["pairs"]],
            b0=_np(f.b0).astype(np.float64), prior_g=float(kw["prior_g"]),
            prior_a=float(kw["prior_a"]), fix_scale=bool(kw.get("fix_scale", False)),
            out=dict(scale=float(_np(res.scale)), Rwg=_np(res.Rwg).astype(np.float64),
                     bias=_np(res.bias).astype(np.float64), vel=_np(res.vel).astype(np.float64))))
    m = sys_.map
    new = _np(m.pt_valid) & (_np(m.pt_first_frame) >= i0)
    est = [(f.index, p) for f, p in zip(log, poses) if p is not None]
    out = dict(feats=feats, pairs=pairs, tracks=tracks, bas=bas, vis=vis, inits=inits,
               new_points=_np(m.pt_xyz)[new],
               est_index=np.array([e[0] for e in est], np.int64),
               est_R=np.array([e[1][0] for e in est], np.float64).reshape(-1, 3, 3),
               est_center=np.array([e[1][1] for e in est], np.float64).reshape(-1, 3))
    out["init"] = dict(map_frame=(sys_.init_info or {}).get("frame"), resets=sys_.n_resets)
    if hasattr(sys_, "imu_initialized"):
        out["imu_initialized"] = bool(sys_.imu_initialized)
        out["init"].update(imu=bool(sys_.imu_initialized), viba1=bool(sys_.viba1_done),
                           last_imu_stage_frame=sys_.last_imu_stage_frame)
    return out


def judge(produced: dict, seq, config: dict) -> dict:
    num = config["preset_numbers"]
    orb = num["orb"]
    values = {}
    if produced["feats"]:
        values["desc_wrong"] = max(
            ref.check_extraction(f["image"], f["xy"], f["octave"], f["desc"],
                                 orb["n_levels"], orb["scale_factor"])["desc_wrong"]
            for per in produced["feats"].values() for f in per)
    if produced.get("pairs"):
        fx, b = num["cam_params"][0], num["stereo"]["baseline"]
        gates = ref.stereo_gates(b, num["stereo"]["max_depth_factor"], orb["scale_factor"])
        got = {i: ref.check_stereo(p, seq.frames[i], seq.right[i], fx, b, gates)
               for i, p in produced["pairs"].items()}
        values["stereo_wrong"] = max(g["wrong"] for g in got.values())
        values["stereo_ur_gap_px"] = max(g["ur_gap_px"] for g in got.values())
        values["stereo_depth_rel_gap"] = max(g["depth_rel_gap"] for g in got.values())
        values["stereo_each"] = [(i, g["wrong"], g["n"], g["n_assoc"]) for i, g in got.items()]
    gaps = []
    for i, t in produced["tracks"].items():
        if t["inliers"].sum() < 6:
            continue
        g = ref.check_pose_schedule(t, num["cam_params"], orb["scale_factor"])
        m = t["inliers"]
        opt = ref.check_pose(t["R"], t["t"], t["X"][m], t["uv"][m], t["octave"][m],
                             num["cam_params"], orb["scale_factor"])["gap_px"]
        gaps.append((i, g["gap_px"], g["flips"], g["n"], opt))
    if gaps:
        values["pose_gap_px"] = max(g[1] for g in gaps)
        values["pose_opt_gap_px"] = max(g[4] for g in gaps)
        values["pose_each"] = gaps
    est, idx = produced["est_center"], produced["est_index"]
    if idx.size >= 3 and produced.get("imu_initialized", True):
        gt_R = np.stack([seq.path.pose64(seq.ts[i])[0] for i in idx])
        traj = ref.check_trajectory(est, seq.centers[idx], produced["est_R"], gt_R)
        values.update(ate_share=traj["ate_share"], scale_err=abs(traj["scale"] - 1.0),
                      tilt_deg=traj["tilt_deg"])
        s, R, t = traj["align"]
        pts = produced["new_points"]
        if pts.shape[0]:
            height = float(np.mean(np.abs(seq.centers[idx, 2])))
            values["map_height"] = float(np.median(
                ref.surface_height(s * pts @ R.T + t, scene.DEFAULT_MESAS))) / height
    K4 = num["cam_params"]
    sf = orb["scale_factor"]
    if produced["bas"]:
        got = [optimum.check_ba(b, K4, sf) for b in produced["bas"]]
        values["ba_undone"] = max(g["undone"] for g in got)
        values["ba_each"] = [(b["frame"], g["undone"], g["n_obs"])
                             for b, g in zip(produced["bas"], got)]
        values["ba_gap_px"] = max(g["gap_px"] for g in got)
    imu = num.get("imu")
    if imu is not None:
        samples = [s for per in seq.imu for s in per]
        Tbc = np.asarray(imu["Tbc"], np.float64).reshape(4, 4)
        if produced["vis"]:
            got = [optimum.check_vi_pose(v, [s for s in samples if v["t0"] < s[0] <= v["t1"]],
                                         imu, K4, Tbc, sf) for v in produced["vis"]]
            values["vi_undone"] = max(g["undone"] for g in got)
            values["vi_each"] = [(v["frame"], g["kind"], g["undone"])
                                 for v, g in zip(produced["vis"], got)]
            values["vi_gap_px"] = max(g["gap_px"] for g in got)
            for kind in ("lastkf", "lastframe"):
                mine = [g["undone"] for g in got if g["kind"] == kind]
                if mine:
                    values[f"vi_undone.{kind}"] = max(mine)
        if produced["inits"]:
            got = [optimum.check_imu_init(c, samples, imu) for c in produced["inits"]]
            values["init_undone"] = max(g["undone"] for g in got)
            for k in ("gravity_deg", "scale_gap", "vel_gap", "bias_gap"):
                values[f"init_{k}"] = max(g[k] for g in got)
    checks = {name: dict(value=values.get(name), limit=limit)
              for name, limit in config["checks"].items()}
    ok = all(c["value"] is not None and bool(np.isfinite(c["value"])) and c["value"] <= c["limit"]
             for c in checks.values())
    readings = {k: v for k, v in values.items() if k not in checks}
    return dict(correct=bool(ok), checks=checks, readings=readings)
