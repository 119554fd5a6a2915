"""Micro-drive: visual against inertial keyframe-frame wall time.

    python -m orbslam3_tpu_torch.tools.drives.drive_kf_times [--frames 120] [--device cuda|cpu]

The port of `tools/drives/drive_kf_times.py`, with the same scenes, seeds,
configuration and gate.  It runs the synthetic-feature visual pipeline
(`utils/synthetic_world.camera_path`, world seed 2) and the mono-inertial
pipeline (`camera_path_smooth`, world seed 3, a 200 Hz IMU) with the same
keyframe cadence and caps, times every `track_monocular` call on the host
clock, splits tracked frames from keyframe frames by `n_kf_host`, and
reports the medians: for the visual run after the first third of the
frames, for the inertial run once the IMU is initialized.  The difference
of the two keyframe-frame medians is the VI window BA's cost over the
visual window BA.  Features are made on the host and uploaded; nothing is
extracted.

The JAX drive's world and paths come from its test modules, which import
JAX; the port's are `utils/synthetic_world.py`.  `--frames` (the port's
own; default 120, JAX's fixed count) cuts both runs for a rehearsal.  Each
frame ends with the port's blocking read of its inlier count and pose, so
the host clock includes the frame's device work.

Prints `DRIVE PASS` (0 resets in both runs, IMU initialized) or
`DRIVE FAIL` and exits 0 or 1.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import add_device_arg, device_name, device_of


def median_ms(xs):
    return 1e3 * float(np.median(np.asarray(xs))) if xs else float("nan")


def _config(**kw):
    from ...pipeline import system as slam_system
    from ...utils.synthetic_world import HW, K4
    return slam_system.SlamConfig(cam_params=K4, image_hw=HW, min_init_matches=80,
                                  max_frames_between_kf=6, ba_caps=(24, 4096, 16384), **kw)


def run_visual(dev, n_frames=120):
    from ...pipeline import system as slam_system
    from ...utils.synthetic_world import SyntheticWorld, camera_path

    world = SyntheticWorld(seed=2)
    poses = camera_path(n_frames)
    sys_ = slam_system.System(_config(), device=dev)
    track_t, kf_t = [], []
    for i, (R_cw, t_cw, _) in enumerate(poses):
        ff = world.frame(R_cw, t_cw, device=dev)
        nk0 = sys_.n_kf_host
        t0 = time.perf_counter()
        sys_.track_monocular(None, ts=i * 0.05, features=ff)
        dt = time.perf_counter() - t0
        if i > n_frames // 3:                 # steady state only
            (kf_t if sys_.n_kf_host > nk0 else track_t).append(dt)
    return track_t, kf_t, sys_.n_resets


def run_inertial(dev, n_frames=120):
    from ...pipeline import inertial_system
    from ...utils import synthetic_world as sw

    world = sw.SyntheticWorld(seed=3)
    frames, pos, vel, acc, rot, rot_rate = sw.camera_path_smooth(n_frames)
    icfg = inertial_system.InertialConfig(imu_freq=sw.IMU_HZ, init_time_s=1.5, init_min_kfs=5)
    sys_ = inertial_system.InertialSystem(_config(), icfg, device=dev)
    dt_f = 1.0 / sw.FPS
    track_t, kf_t = [], []
    for i in range(n_frames):
        t_frame = i * dt_f
        if i > 0:
            for tm, w, a in sw.imu_between((i - 1) * dt_f, t_frame, rot, acc, rot_rate):
                sys_.grab_imu(tm, w, a)
        R_cw, t_cw, _, _ = frames[i]
        ff = world.frame(R_cw, t_cw, device=dev)
        nk0 = sys_.n_kf_host
        t0 = time.perf_counter()
        sys_.track_monocular(None, ts=t_frame, features=ff)
        dt = time.perf_counter() - t0
        if sys_.imu_initialized:              # VI-BA path engaged
            (kf_t if sys_.n_kf_host > nk0 else track_t).append(dt)
    return track_t, kf_t, sys_.n_resets, sys_.imu_initialized


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.drives.drive_kf_times")
    ap.add_argument("--frames", type=int, default=120,
                    help="frames of each run (default 120, the JAX drive's)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(ap, args.device)
    print("device:", device_name(dev), flush=True)
    t0 = time.time()
    vt, vk, vr = run_visual(dev, args.frames)
    print(f"visual: tracked {median_ms(vt):.2f} ms (n={len(vt)})  "
          f"KF frame {median_ms(vk):.2f} ms (n={len(vk)})  resets={vr} "
          f"[{time.time() - t0:.0f}s]", flush=True)
    t0 = time.time()
    it, ik, ir, init = run_inertial(dev, args.frames)
    print(f"inertial: tracked {median_ms(it):.2f} ms (n={len(it)})  "
          f"KF frame {median_ms(ik):.2f} ms (n={len(ik)})  resets={ir} "
          f"imu_init={init} [{time.time() - t0:.0f}s]", flush=True)
    gap = median_ms(ik) - median_ms(vk)
    print(f"inertial-KF minus visual-KF: {gap:+.2f} ms", flush=True)
    ok = vr == 0 and ir == 0 and init
    print("DRIVE " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
