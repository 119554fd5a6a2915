"""Verification drive: a stressed loop circuit with closure + GBA.

    python -m orbslam3_tpu_torch.tools.drives.drive_loop [--device cuda|cpu]

The port of `tools/drives/drive_loop.py`, with the same scene, stress
schedule, configuration, gates and `DRIVE_FRAMES` (default 600).  A
look-down camera flies one full lap of a 36 m circuit over a textured
plane with elevated mesas, with hostile photometrics (under-exposure,
motion blur, sensor noise) over the middle 70% of the lap to accumulate
genuine drift, then retraces the start of the lap.  Each frame is rendered,
extracted by `features/extractor.extract` on the System's device (the
`orb_describe` kernel on a card) and fed to the `System` with loop closing
enabled.  Verifies
  * sustained tracking (0 resets) through the photometric stress,
  * loop detection fires through NBest + group-consistency (the reference
    LoopClosing::DetectLoop chain),
  * the loop correction + the pending post-loop GBA are absorbed: the JAX
    drive's `_merge_pending(force=True)` is the port's
    `System._drain_pending()`, which merges until nothing is pending
    (ROADMAP queue 3, "a forced merge drains the pending slot"),
  * the final scale-aligned ATE is centimetric (float32, `ops.align`).

Prints `DRIVE PASS` or `DRIVE FAIL` and exits 0 or 1.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .. import add_device_arg, device_name, device_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.drives.drive_loop")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from ...features.extractor import OrbParams, extract
    from ...ops import align
    from ...pipeline import system as base_sys
    from ...slam_map import state as mapstate
    from ...utils import synth_render as sr

    dev = device_of(ap, args.device)
    print("device:", device_name(dev), flush=True)

    HW = (240, 376)
    K4 = (230.0, 230.0, 188.0, 120.0)
    rng = np.random.default_rng(7)
    tex = sr.block_texture(rng, block=10)
    mesas = sr.default_mesas(rng)

    # 36 m circuit: radius such that 2*pi*r = 36
    r_circ = 36.0 / (2 * np.pi)
    lap = 480                       # frames for one lap
    # lap + 25% retrace for the detection chain
    n_frames = int(os.environ.get("DRIVE_FRAMES", 600))
    dt = 0.1

    def pose(i):
        phi = 2 * np.pi * i / lap
        x = r_circ * np.cos(phi)
        y = r_circ * np.sin(phi)
        # heading follows the path so the revisit sees the start imagery
        # at the same orientation
        return sr.look_down_pose(x, y, 5.0, yaw=phi)

    def render(i):
        R_cw, t_cw = pose(i)
        img = sr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex,
                              tex_scale=40.0, mesas=mesas)
        u = (i % lap) / lap
        # hostile middle 70% of the lap: strong enough that the lap
        # accumulates real drift, so that the revisit is not covisible
        # and the loop has something to close
        if 0.15 < u < 0.85:
            img = sr.photometric_stress(
                img, exposure=0.45, gamma=1.2, vignette=0.45,
                blur_px=2.5 if i % 3 != 2 else 0.0, blur_dir=(1.0, 0.4),
                noise=10.0, rng=rng)
        return img

    # 600 features (against the production 1200): a larger budget tracks
    # the stressed lap with only a few cm of drift and the revisit stays
    # covisible, with no closure to exercise
    p = OrbParams(n_features=600, n_levels=4)
    cfg = base_sys.SlamConfig(
        cam_model="pinhole", cam_params=K4, image_hw=HW, orb=p,
        min_init_matches=60, min_track_inliers=20,
        max_frames_between_kf=6, new_pt_budget=512,
        ba_caps=(16, 2048, 8192), enable_loop_closing=True,
        post_loop_gba=True)
    sys_ = base_sys.System(cfg, device=dev)

    t0 = time.time()
    gt = []
    n_ok = 0
    for i in range(n_frames):
        img = render(i)
        ff = extract(mapstate._upload(img, dev), p)
        st, _ = sys_.track_monocular(None, ts=i * dt, features=ff)
        R_cw, t_cw = pose(i)
        gt.append(-R_cw.T @ t_cw)
        if st == base_sys.OK:
            n_ok += 1
        if i % 50 == 0:
            print(f"frame {i}: state={st} loops="
                  f"{sys_.loop_closer.n_loops_closed} "
                  f"resets={sys_.n_resets} t={time.time() - t0:.0f}s",
                  flush=True)
    sys_._drain_pending()   # absorb any pending post-loop GBA
    wall = time.time() - t0

    est = np.stack([p_[2] for p_ in sys_.trajectory]).astype(np.float32)
    ts_used = [p_[0] for p_ in sys_.trajectory]
    gt_m = np.stack([gt[int(round(t / dt))] for t in ts_used]).astype(np.float32)
    rmse, s, _, _ = align.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt_m))
    # post-loop segment (last quarter: the corrected, re-anchored part)
    q = 3 * len(est) // 4
    rmse_q, _, _, _ = align.ate_rmse(torch.from_numpy(est[q:]), torch.from_numpy(gt_m[q:]))

    print(f"\nframes tracked OK: {n_ok}/{n_frames}")
    print(f"resets: {sys_.n_resets}  map switches: {sys_.n_map_switches}")
    print(f"loops closed: {sys_.loop_closer.n_loops_closed}")
    print(f"keyframes: {sys_.n_kf_host}")
    print(f"ATE rmse: {float(rmse) * 100:.2f} cm  (scale {float(s):.4f}); "
          f"last-quarter {float(rmse_q) * 100:.2f} cm")
    print(f"wall: {wall:.0f} s")

    # full-trajectory gate 20 cm on the 36 m stressed circuit (the
    # middle of the lap keeps residual drift the single loop edge can't
    # remove); the corrected tail must be tight
    ok = (sys_.n_resets == 0 and n_ok > 0.9 * n_frames and
          sys_.loop_closer.n_loops_closed >= 1 and float(rmse) < 0.20 and
          float(rmse_q) < 0.08)
    print("DRIVE " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
