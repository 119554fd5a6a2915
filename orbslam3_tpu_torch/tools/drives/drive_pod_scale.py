"""Verification drive: the engine at pod-scale capacity (1024 keyframes).

    python -m orbslam3_tpu_torch.tools.drives.drive_pod_scale [--device cuda|cpu]

The port of `tools/drives/drive_pod_scale.py`, with the same world
(`CircuitWorld`: NumPy, the same seeds and calls, so the same frames bit for
bit, descriptors as int32 bit patterns), capacity
`MapCapacity(1024, 98304, 786432)`, configuration, `DRIVE_FRAMES` (default
6600) and `POD_GBA` variables, printed lines and gates.  It runs the full
System with loop closing on a long synthetic-feature circuit that closes
its loop at ~900 keyframes:

  * sustained tracking across ~6k frames with compaction and culling churn
    at capacity (0 resets),
  * loop detection runs the chunked covisibility path at every keyframe
    (98304 x 1024 incidence, far past the dense cutoff),
  * the closure fires with K >= 512, so the essential graph runs the
    matrix-free CG solver (`solver/pose_graph.py` picks CG at K >= 512),
  * the post-loop GBA (`POD_GBA=1`, the default) over the whole capacity of
    786,432 observation rows; the JAX drive's `_merge_pending(force=True)`
    that absorbs it is the port's `System._drain_pending()`, which merges
    until nothing is pending (ROADMAP queue 3, "a forced merge drains the
    pending slot").

Beside JAX's lines it prints the keyframe count at each closure and, on a
card, `torch.cuda.max_memory_allocated`.  Features are made on the host and
uploaded; nothing is extracted.  `DRIVE_FRAMES` scales the circuit for
rehearsals: below 6000 frames the gate drops the keyframe, loop and ATE
conditions, as in JAX.

Prints `DRIVE PASS` or `DRIVE FAIL` and exits 0 or 1.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .. import add_device_arg, device_name, device_of

K4 = (230.0, 230.0, 188.0, 120.0)
HW = (240, 376)
N_KP = 512


class CircuitWorld:
    """Landmark annulus under a look-down circuit flight.  Big enough that
    ~1000 distinct keyframes see mostly fresh landmarks, with the revisit at
    the lap's end seeing the start's imagery again."""

    def __init__(self, r_circ: float, seed=11, per_m=260):
        rng = np.random.default_rng(seed)
        n = int(2 * np.pi * r_circ * per_m)
        phi = rng.uniform(0, 2 * np.pi, n)
        rad = r_circ + rng.uniform(-2.5, 2.5, n)
        self.X = np.stack([
            rad * np.cos(phi), rad * np.sin(phi),
            rng.uniform(-0.6, 0.6, n)], 1).astype(np.float32)
        self.desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        self.rng = rng
        print(f"world: {n} landmarks over a "
              f"{2 * np.pi * r_circ:.0f} m circuit", flush=True)

    def frame(self, R_cw, t_cw, noise_px=0.4, dropout=0.35, device="cpu"):
        import torch

        from ...features.extractor import FeatureFrame
        from ...slam_map.state import _upload

        Xc = self.X @ np.asarray(R_cw).T + np.asarray(t_cw)
        z = Xc[:, 2]
        uv = np.stack([K4[0] * Xc[:, 0] / np.maximum(z, 1e-6) + K4[2],
                       K4[1] * Xc[:, 1] / np.maximum(z, 1e-6) + K4[3]], 1)
        vis = (z > 0.3) & (uv[:, 0] > 8) & (uv[:, 0] < HW[1] - 8) & \
              (uv[:, 1] > 8) & (uv[:, 1] < HW[0] - 8)
        vis &= self.rng.random(len(z)) > dropout
        idx = np.nonzero(vis)[0]
        self.rng.shuffle(idx)
        idx = idx[:N_KP]
        n = len(idx)
        xy = uv[idx] + noise_px * self.rng.standard_normal((n, 2))
        desc = self.desc[idx].copy()
        w = self.rng.integers(0, 8, n)
        b = self.rng.integers(0, 32, n)
        desc[np.arange(n), w] ^= (np.uint32(1) << b.astype(np.uint32))
        pad = N_KP - n
        xy = np.concatenate([xy, np.zeros((pad, 2))]).astype(np.float32)
        desc = np.concatenate([desc, np.zeros((pad, 8), np.uint32)]).view(np.int32)
        return FeatureFrame(
            xy=_upload(xy, device), response=torch.ones(N_KP, device=device),
            octave=torch.zeros(N_KP, dtype=torch.int32, device=device),
            angle=torch.zeros(N_KP, device=device), desc=_upload(desc, device),
            valid=_upload(np.arange(N_KP) < n, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.drives.drive_pod_scale")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from ...ops import align
    from ...pipeline import system as base_sys
    from ...slam_map import state as mapstate
    from ...utils import synth_render as sr

    dev = device_of(ap, args.device)
    print("device:", device_name(dev), flush=True)

    n_frames = int(os.environ.get("DRIVE_FRAMES", 6600))
    lap = int(n_frames / 1.1)          # close the loop, retrace ~10%
    dt = 0.05
    # speed sized so one lap ~= lap frames; a keyframe every ~6 frames ->
    # ~lap/6 keyframes at the closure (~1000 at the default length)
    r_circ = 0.05 * lap / (2 * np.pi)   # 0.05 m / frame along the arc
    world = CircuitWorld(r_circ)

    cap = mapstate.MapCapacity(n_kf=1024, n_pt=98304, n_obs=786432)
    cfg = base_sys.SlamConfig(
        cam_params=K4, image_hw=HW, min_init_matches=60,
        min_track_inliers=20, max_frames_between_kf=6,
        new_pt_budget=192, ba_caps=(16, 4096, 12288),
        map_capacity=cap, enable_loop_closing=True,
        post_loop_gba=os.environ.get("POD_GBA", "1") == "1",
        local_view_points=8192)
    sys_ = base_sys.System(cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def pose(i):
        phi = 2 * np.pi * (i % lap) / lap
        x = r_circ * np.cos(phi)
        y = r_circ * np.sin(phi)
        return sr.look_down_pose(x, y, 5.0, yaw=phi)

    t0 = time.time()
    gt = []
    track_t, kf_t = [], []
    loop_k = []
    n_ok = 0
    for i in range(n_frames):
        R_cw, t_cw = pose(i)
        ff = world.frame(R_cw, t_cw, device=dev)
        nk0 = sys_.n_kf_host
        nl0 = sys_.loop_closer.n_loops_closed
        f0 = time.perf_counter()
        st, _ = sys_.track_monocular(None, ts=i * dt, features=ff)
        f1 = time.perf_counter()
        if i > 60:
            (kf_t if sys_.n_kf_host > nk0 else track_t).append(f1 - f0)
        if sys_.loop_closer.n_loops_closed > nl0:
            loop_k.append((i, sys_.n_kf_host))
        gt.append(-R_cw.T @ t_cw)
        if st == base_sys.OK:
            n_ok += 1
        if i % 500 == 0:
            print(f"frame {i}: state={st} n_kf={sys_.n_kf_host} "
                  f"n_pt={int(sys_.map.n_pt)} "
                  f"loops={sys_.loop_closer.n_loops_closed} "
                  f"resets={sys_.n_resets} t={time.time() - t0:.0f}s",
                  flush=True)
    g0 = time.perf_counter()
    sys_._drain_pending()    # absorb the pending post-loop GBA
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gba_absorb_s = time.perf_counter() - g0
    wall = time.time() - t0

    est = np.stack([p_[2] for p_ in sys_.trajectory]).astype(np.float32)
    ts_used = [p_[0] for p_ in sys_.trajectory]
    gt_m = np.stack([gt[int(round(t / dt))] for t in ts_used]).astype(np.float32)
    rmse, s, _, _ = align.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt_m))
    q = 3 * len(est) // 4
    rmse_q, _, _, _ = align.ate_rmse(torch.from_numpy(est[q:]), torch.from_numpy(gt_m[q:]))

    def med(xs):
        return 1e3 * float(np.median(xs)) if xs else float("nan")

    n_kf = sys_.n_kf_host
    n_pt_live = int(sys_.map.pt_valid.sum())
    n_obs = int(sys_.map.n_obs)
    loops = sys_.loop_closer.n_loops_closed
    print(f"\nframes OK: {n_ok}/{n_frames}  resets: {sys_.n_resets}")
    print(f"keyframes: {n_kf} (capacity {cap.n_kf})  live points: "
          f"{n_pt_live}  obs: {n_obs}")
    print(f"loops closed: {loops} (first at K>=512: "
          f"{'yes' if loops and n_kf >= 512 else 'n/a'})")
    print("loop closures (frame, keyframes): "
          + (", ".join(f"({f}, {k})" for f, k in loop_k) or "none"))
    print(f"tracked frame median {med(track_t):.1f} ms  KF frame median "
          f"{med(kf_t):.1f} ms  GBA absorb {gba_absorb_s:.1f} s")
    print(f"ATE (scale-aligned) {100 * float(rmse):.1f} cm  scale "
          f"{float(s):.4f}  last-quarter {100 * float(rmse_q):.1f} cm")
    if dev.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    print(f"wall: {wall:.0f} s")

    full = n_frames >= 6000
    ok = (sys_.n_resets == 0 and n_ok > 0.9 * n_frames and
          (not full or (n_kf >= 700 and loops >= 1 and
                        float(rmse) < 1.0)))
    print("DRIVE PASS" if ok else "DRIVE FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
