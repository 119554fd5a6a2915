"""Verification drive: a mono-inertial loop closure (the 4-DoF graph).

    python -m orbslam3_tpu_torch.tools.drives.drive_vi_loop [--device cuda|cpu]

The port of `tools/drives/drive_vi_loop.py`, with the same circuit, IMU
synthesis, stress schedule, configuration, gates, `DRIVE_FRAMES` (default
300: 1.25 laps at 20 Hz) and `DRIVE_DUMP`.  A mono-inertial System flies a
closed circuit over a textured plane with mesas; the IMU is analytic (gyro =
heading rate, accel = centripetal + radial / height oscillation for scale
observability); photometric stress over the middle of the lap accumulates
genuine drift; then the camera retraces the start.  After the IMU
initializes (a metric, gravity-aligned map), the loop closure runs the
gauge-constrained 4-DoF essential graph with velocity transport.  Each frame
is rendered at 240x376 and extracted with 900 features over 4 levels by
`features/extractor.extract` on the System's device (the `orb_describe`
kernel on a card).  Verifies
  * the IMU initialization fires and the map is metric (alignment scale
    within 5% of 1 over the second half),
  * the loop closes on the inertial map with 0 resets,
  * metric scale survives the correction: the alignment scale at the
    closure over the rolling one before it within 1%,
  * tracking continues through the post-loop VI windows without resets,
  * the corrected segment (after the closure, before lap 2 re-enters the
    stress) is centimetric: median below 8 cm and RMSE below 20 cm in the
    SE3 gauge; the second half's ATE below 60 cm.

Where the port differs: the JAX drive's `_merge_pending(force=True)` is the
port's `System._drain_pending()`, which merges until nothing is pending
(ROADMAP queue 3, "a forced merge drains the pending slot"); after the
closure the tracker's velocity rides the loop correction, where JAX's
restarts from rest (ROADMAP queue 3, "the tracker's velocity rides a loop
correction"); the alignments are the port's float32 `ops/align.ate_rmse`, as
JAX's are float32.  The
scene's functions are module-level (`render` takes the generator that JAX's
closure shares), so that tests can hold them against the JAX drive's.

Prints `DRIVE PASS` or `DRIVE FAIL` and exits 0 or 1.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .. import add_device_arg, device_name, device_of
from ...utils import synth_render as sr

FPS = 20.0
IMU_HZ = 200.0
G_W = np.array([0.0, 0.0, -9.81])

# circuit: radius wobble + height wobble for accelerometer excitation,
# heading oscillation on top of the lap heading — a constant-rate turn
# is a DEGENERATE VI trajectory (body-frame centripetal acceleration is
# constant, the accelerometer bias absorbs it and the scale drifts); the
# oscillation rotates the centripetal direction in the body frame and
# restores observability
R0, DR, W2 = 18.0 / (2 * np.pi), 0.35, 2.1
DZ, W3 = 0.25, 1.6
LAP_S = 12.0                      # one lap
W1 = 2 * np.pi / LAP_S
A_H, W_H = 0.35, 1.3              # heading oscillation [rad], [rad/s]

HW = (240, 376)
K4 = (230.0, 230.0, 188.0, 120.0)


def rho(t):
    return R0 + DR * np.sin(W2 * t)


def center(t):
    ph = W1 * t
    return np.array([rho(t) * np.cos(ph), rho(t) * np.sin(ph),
                     -5.0 + DZ * np.sin(W3 * t)])


def accel_w(t):
    ph = W1 * t
    rp = DR * W2 * np.cos(W2 * t)
    rpp = -DR * W2 * W2 * np.sin(W2 * t)
    r = rho(t)
    ax = rpp * np.cos(ph) - 2 * rp * W1 * np.sin(ph) - r * W1 * W1 * np.cos(ph)
    ay = rpp * np.sin(ph) + 2 * rp * W1 * np.cos(ph) - r * W1 * W1 * np.sin(ph)
    az = -DZ * W3 * W3 * np.sin(W3 * t)
    return np.array([ax, ay, az])


def heading(t):
    return W1 * t + A_H * np.sin(W_H * t)


def heading_rate(t):
    return W1 + A_H * W_H * np.cos(W_H * t)


def pose(t, sr=sr):
    c = center(t)
    return sr.look_down_pose(c[0], c[1], -c[2], yaw=heading(t))


def imu_samples(i: int) -> list:
    """The 200 Hz samples (tm, gyro, acc_body) of ((i-1)/FPS, i/FPS], each read
    at its interval's midpoint."""
    if i == 0:
        return []
    dt_i = 1.0 / IMU_HZ
    t_frame, t_prev = i / FPS, (i - 1) / FPS
    out = []
    k = 1
    while t_prev + k * dt_i <= t_frame + 1e-9:
        tm = t_prev + k * dt_i
        ts_mid = tm - 0.5 * dt_i
        R_cw, _ = pose(ts_mid)
        gyro = np.array([0.0, 0.0, heading_rate(ts_mid)])
        acc_b = R_cw @ (accel_w(ts_mid) - G_W)
        out.append((tm, gyro, acc_b))
        k += 1
    return out


def make_scene():
    """(generator, texture, mesas): the texture and the mesas drawn first,
    the stress noise of every frame after them from the same generator."""
    rng = np.random.default_rng(9)
    tex = sr.block_texture(rng, block=10)
    mesas = sr.default_mesas(rng)
    return rng, tex, mesas


def render(i, rng, tex, mesas):
    """Frame i (float32); frames must be rendered in order (the stress draws
    its noise from `rng`)."""
    lap_frames = int(LAP_S * FPS)
    t = i / FPS
    R_cw, t_cw = pose(t)
    img = sr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex,
                          tex_scale=40.0, mesas=mesas)
    u = (i % lap_frames) / lap_frames
    if 0.2 < u < 0.8:
        # strong stress over the middle of the lap: with the window BA
        # holding the IMU chain, mild stress leaves the map so accurate
        # that the revisit re-attaches to the old points by projection and
        # no loop is needed; the stress must defeat tracking enough to
        # accumulate genuine drift
        img = sr.photometric_stress(
            img, exposure=0.65, gamma=1.1, vignette=0.3,
            blur_px=2.0 if i % 3 == 0 else 0.0, blur_dir=(1.0, 0.4),
            noise=4.0, rng=rng)
    return img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.drives.drive_vi_loop")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from ...features.extractor import OrbParams, extract
    from ...ops import align
    from ...pipeline import inertial_system
    from ...pipeline import system as base_sys
    from ...slam_map import state as mapstate

    dev = device_of(ap, args.device)
    print("device:", device_name(dev), flush=True)

    rng, tex, mesas = make_scene()
    n_frames = int(os.environ.get("DRIVE_FRAMES", 300))                # 1.25 laps at 20 Hz
    lap_frames = int(LAP_S * FPS)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))

    p = OrbParams(n_features=900, n_levels=4)
    cfg = base_sys.SlamConfig(
        cam_model="pinhole", cam_params=K4, image_hw=HW, orb=p,
        min_init_matches=60, min_track_inliers=20,
        max_frames_between_kf=6, new_pt_budget=512,
        ba_caps=(16, 2048, 8192), enable_loop_closing=True,
        post_loop_gba=True)
    icfg = inertial_system.InertialConfig(
        imu_freq=IMU_HZ, init_time_s=1.5, init_min_kfs=5,
        refine2_time_s=9.0)   # VIBA2 inside the 15 s drive
    sys_ = inertial_system.InertialSystem(cfg, icfg, device=dev)

    t0_wall = time.time()
    gt = []
    inl = []
    n_ok = 0
    scale_at_loop = None
    scale_before_loop = None
    loop_frame = None

    def align_scale():
        est = np.stack([p_[2] for p_ in sys_.trajectory])
        ts_used = [p_[0] for p_ in sys_.trajectory]
        gt_m = np.stack([gt[int(round(tt * FPS))] for tt in ts_used])
        h = len(est) // 2
        _, s_l, _, _ = align.ate_rmse(f32(est[h:]), f32(gt_m[h:]))
        return float(s_l)

    for i in range(n_frames):
        t_frame = i / FPS
        for tm, gyro, acc_b in imu_samples(i):
            sys_.grab_imu(tm, gyro, acc_b)
        img = render(i, rng, tex, mesas)
        ff = extract(mapstate._upload(img, dev), p)
        st, _ = sys_.track_monocular(None, ts=t_frame, features=ff)
        R_cw, t_cw = pose(t_frame)
        gt.append(-R_cw.T @ t_cw)
        if st == base_sys.OK:
            n_ok += 1
        inl.append(getattr(sys_, "last_track_inliers", -1))
        n_loops = sys_.loop_closer.n_loops_closed
        if n_loops == 0 and sys_.imu_initialized and i % 10 == 0 and \
                len(sys_.trajectory) > 20:
            # rolling pre-closure metric scale (the preservation anchor)
            scale_before_loop = align_scale()
        if scale_at_loop is None and n_loops >= 1:
            scale_at_loop = align_scale()
            loop_frame = i
            print(f"loop closed at frame {i}; alignment scale "
                  f"{scale_before_loop} -> {scale_at_loop:.4f}",
                  flush=True)
        if i % 50 == 0:
            print(f"frame {i}: state={st} imu_init={sys_.imu_initialized} "
                  f"loops={n_loops} resets={sys_.n_resets} "
                  f"t={time.time() - t0_wall:.0f}s", flush=True)
    sys_._drain_pending()
    wall = time.time() - t0_wall

    est = np.stack([p_[2] for p_ in sys_.trajectory])
    ts_used = [p_[0] for p_ in sys_.trajectory]
    gt_m = np.stack([gt[int(round(tt * FPS))] for tt in ts_used])
    h = len(est) // 2
    rmse, s, _, _ = align.ate_rmse(f32(est[h:]), f32(gt_m[h:]))
    # corrected segment: strictly after the closure and before lap 2
    # re-enters the stress region (frames there track against the
    # drift-distorted mid-lap map until the pending post-loop GBA lands,
    # and frames before the closure carry the drift the closure exists to
    # correct)
    t_lo = (loop_frame + 4) / FPS if loop_frame is not None else 0.0
    t_hi = (lap_frames * 1.2 - 1) / FPS
    sel = [k for k, tt in enumerate(ts_used) if t_lo <= tt <= t_hi]
    if len(sel) >= 10:
        # SE3 alignment (scale fixed at 1: the map is metric, and a free
        # Umeyama scale over a short arc is ill-conditioned); the median is
        # the typical accuracy, the RMSE bounds the transient single-frame
        # pose blips around map-update frames
        rmse_q, _, Rq, tq = align.ate_rmse(f32(est[sel]), f32(gt_m[sel]), with_scale=False)
        e_al = (f32(est[sel]) @ Rq.T + tq).numpy()
        med_q = float(np.median(np.linalg.norm(e_al - gt_m[sel], axis=1)))
    else:
        rmse_q, med_q = float("inf"), float("inf")

    print(f"\nframes OK: {n_ok}/{n_frames}  resets: {sys_.n_resets}")
    print(f"imu_initialized: {sys_.imu_initialized}  "
          f"loops: {sys_.loop_closer.n_loops_closed}")
    print(f"post-loop ATE (2nd half): {float(rmse) * 100:.2f} cm  "
          f"alignment scale {float(s):.4f}; corrected segment "
          f"rmse {float(rmse_q) * 100:.2f} cm median {med_q * 100:.2f} cm"
          f" (SE3 align)")
    print(f"wall: {wall:.0f} s")
    dump = os.environ.get("DRIVE_DUMP")
    if dump:
        m = sys_.map
        np.savez(dump, est=est, gt=gt_m, ts=np.asarray(ts_used),
                 inl=np.asarray(inl),
                 loop_frame=-1 if loop_frame is None else loop_frame,
                 kf_R=m.kf_R.cpu().numpy(), kf_t=m.kf_t.cpu().numpy(),
                 kf_ts=m.kf_ts.cpu().numpy(), n_kf=int(m.n_kf))

    # gauge check: the 4-DoF correction must preserve the metric scale the
    # IMU established (ratio across the closure within 1%); the corrected
    # segment must be tight in the SE3 (metric) gauge; the second half's
    # alignment scale (long arc, well-conditioned) must be metric
    preserved = (scale_at_loop is None or scale_before_loop is None or
                 abs(scale_at_loop / scale_before_loop - 1.0) < 0.01)
    ok = (sys_.n_resets == 0 and sys_.imu_initialized and
          sys_.loop_closer.n_loops_closed >= 1 and preserved and
          med_q < 0.08 and float(rmse_q) < 0.20 and
          abs(float(s) - 1.0) < 0.05 and float(rmse) < 0.60)
    print("DRIVE " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
