"""Verification drive: mono-inertial SLAM with GNSS georeferencing.

    python -m orbslam3_tpu_torch.tools.drives.drive_vi_gnss [--frames 120] [--device cuda|cpu]

The port of `tools/drives/drive_vi_gnss.py`, with the same scene, seeds,
configuration and asserts.  The `InertialSystem` runs on a synthetic smooth
trajectory with real acceleration (scale observability,
`utils/synthetic_world.camera_path_smooth`, world seed 3), an IMU at 200 Hz,
and a GNSS fix before every frame in a geo frame displaced by a known Sim3
(scale 3, yaw 0.7, offset (500, -200, 30)).  Verifies
  * the IMU initialization fires and the map is metric (alignment scale
    within 0.1 of 1 over the second half, float32 `ops/align.ate_rmse`),
  * the post-init ATE is below 5 cm,
  * the georeferenced trajectory (`System.trajectory_geo`, once
    `georef.initialized`) lands within 15 cm on average of the true geo
    positions over the last 30 frames,
  * at least one GNSS BA was posted (JAX's `_n_gnss_ba` is the port's
    `n_gnss_ba`), 0 resets, tracking OK at the end.

The JAX drive's world and path come from its test modules, which import
JAX; the port's are `utils/synthetic_world.py`.  Features are made on the
host and uploaded; nothing is extracted.  `--frames` (the port's own;
default 120, JAX's fixed count) cuts the run for a rehearsal.

A failed assert raises, as in JAX (exit code 1); the last line is
`DRIVE OK` otherwise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import add_device_arg, device_name, device_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.drives.drive_vi_gnss")
    ap.add_argument("--frames", type=int, default=120,
                    help="frames of the run (default 120, the JAX drive's)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from ...ops import align
    from ...pipeline import inertial_system, system as base_sys
    from ...utils import synthetic_world as sw

    dev = device_of(ap, args.device)
    print("device:", device_name(dev), flush=True)

    world = sw.SyntheticWorld(seed=3)
    n_frames = args.frames
    frames, pos, vel, acc, rot, rot_rate = sw.camera_path_smooth(n_frames)

    # geo frame: x_geo = s_geo * R_yaw x + t_geo
    s_geo = 3.0
    yaw = 0.7
    Rg = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                   [np.sin(yaw), np.cos(yaw), 0],
                   [0, 0, 1.0]])
    t_geo = np.array([500.0, -200.0, 30.0])

    cfg = base_sys.SlamConfig(
        cam_params=sw.K4, image_hw=sw.HW, min_init_matches=80,
        max_frames_between_kf=6, ba_caps=(24, 4096, 16384),
        enable_gnss=True, gnss_sigma=0.05, gnss_min_kfs=8,
        gnss_ba_every=4)
    icfg = inertial_system.InertialConfig(imu_freq=sw.IMU_HZ, init_time_s=1.5, init_min_kfs=5)
    sys_ = inertial_system.InertialSystem(cfg, icfg, device=dev)

    dt_f = 1.0 / sw.FPS
    t_start = time.time()
    for i in range(n_frames):
        t_frame = i * dt_f
        if i > 0:
            for tm, w_body, a_body in sw.imu_between((i - 1) * dt_f, t_frame, rot, acc,
                                                     rot_rate):
                sys_.grab_imu(tm, w_body, a_body)
        # GNSS fix at frame cadence (true geo position of the camera)
        sys_.grab_gnss(t_frame, s_geo * (Rg @ pos(t_frame)) + t_geo)
        R_cw, t_cw, twc, Rwc = frames[i]
        ff = world.frame(R_cw, t_cw, device=dev)
        st, pose = sys_.track_monocular(None, ts=t_frame, features=ff)
        if i % 30 == 0:
            print(f"frame {i}: state={st} imu_init={sys_.imu_initialized} "
                  f"({time.time() - t_start:.1f}s)", flush=True)
    wall = time.time() - t_start

    assert sys_.n_resets == 0, f"resets: {sys_.n_resets}"
    assert sys_.state == base_sys.OK, sys_.state
    assert sys_.imu_initialized, "IMU init never ran"

    est = np.stack([p[2] for p in sys_.trajectory])
    ts_used = [p[0] for p in sys_.trajectory]
    gt = np.stack([pos(t) for t in ts_used])
    n_half = len(est) // 2
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    rmse_s, s, _, _ = align.ate_rmse(f32(est[n_half:]), f32(gt[n_half:]), with_scale=True)
    print(f"post-init ATE {float(rmse_s) * 1000:.2f} mm, "
          f"alignment scale {float(s):.4f}", flush=True)
    assert abs(float(s) - 1.0) < 0.1, float(s)
    assert float(rmse_s) < 0.05, float(rmse_s)

    # geo-referenced trajectory vs true geo positions (last 30 frames)
    assert sys_.georef is not None and sys_.georef.initialized, \
        "georef never initialized"
    geo = sys_.trajectory_geo()
    gt_geo = np.stack([s_geo * (Rg @ pos(t)) + t_geo for t in ts_used])
    err = np.linalg.norm(geo[-30:] - gt_geo[-30:], axis=1)
    print(f"geo-frame abs error (last 30): mean {err.mean() * 100:.2f} cm, "
          f"max {err.max() * 100:.2f} cm", flush=True)
    assert err.mean() < 0.15, err.mean()
    n_gba = sys_.n_gnss_ba
    print(f"gnss BAs dispatched: {n_gba}; wall {wall:.1f}s "
          f"({n_frames / wall:.1f} fps incl. host fixture)", flush=True)
    assert n_gba >= 1, "GNSS BA never dispatched"
    print("DRIVE OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
