"""Diagnostic: where the inertial tracked frame's time goes.

    python -m orbslam3_tpu_torch.tools.drives.drive_vi_chain_ablation [--device cuda|cpu]
        [--cap 200] [--measure 36]

The port of `tools/drives/drive_vi_chain_ablation.py`.  On bench.py's
inertial scene (`bench_full_inertial`: 480x752 at K4 (400, 400, 376, 240),
10 frames per second, a 200 Hz IMU, the bob 0.35 sin(1.2 t) from t = 0,
the texture `block_texture(default_rng(7), block=10)` and the JAX package's
default mesas, `synth_render.DEFAULT_MESAS`) the
`InertialSystem` is warmed up, then three chains run over the same next
`--measure` frames from the same warmed state, each timed after its 6
settle frames:

  A. extract + `track_local_map` + `update_point_stats` (the visual floor);
  B. A with `ops/imu.preintegrate` of the frame's IMU rows and
     `predict_state` as the pose guess;
  C. the port's fused `InertialSystem._vi_track_step` (the weak-match retry
     and the LastFrame VI pose optimization under the carried prior).

Each chain feeds its next frame from its own previous output (the map, the
pose or body state), so the frames cannot overlap; the clock is the host's
with one `torch.cuda.synchronize()` after the settle frames and one at the
end.  Prints JAX's three lines and the two differences (what preintegration
and the prediction cost, what the retry and the VI pose optimization cost),
then what JAX's chains did not have: the blocking host reads per frame of
each chain, counted on a card with `utils/sync_census._sync_warnings` in a
separate pass over the settle frames.

Where the port differs from JAX:
  * The warm-up.  JAX feeds 80 frames and asserts that the IMU is
    initialized.  The port warms up for at least 80 frames and until the
    IMU is initialized (on this scene at frame 78 on the CPU and on the
    card; on the plane without the mesas only at frame 106), at most
    `--cap` frames (default 200), renders frames as it needs them (one
    generator in frame order, as JAX renders them all up front) and prints
    the frame at which the IMU initialized.  If the cap comes first it says
    so, still times the chains on the visual state (prior: identity
    information, as JAX's fallback) and exits 1.
  * Chain B integrates the frame's valid rows only (`preintegrate(n_valid=)`,
    as the port's System does), where JAX scans all 64 masked rows; its line
    names the mean number of rows.
  * `_vi_track_step` takes the System's map and view and a host branch
    choice (`inertial_system.py:318`), where JAX's takes the map and a
    scalar vector; the chain sets `System.map` before each call and builds
    the arguments as `InertialSystem._track_frame` does on a LastFrame frame
    (radius 4, no keyframe rows).  It reads the first attempt's inlier
    count on the host (ROADMAP queue 3), which JAX decides on the device.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from .. import add_device_arg, device_name, device_of
from ...utils import synth_render as sr

HW = (480, 752)
K4 = (400.0, 400.0, 376.0, 240.0)
FPS, IMU_HZ = 10.0, 200.0
G = np.array([0.0, 0.0, -9.81])
MIN_WARMUP = 80
SETTLE = 6


def pose(t):
    x = 0.30 * t
    y = 0.05 * np.sin(1.7 * t)
    z = 5.0 + 0.35 * np.sin(1.2 * t)
    return sr.look_down_pose(x, y, z, yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))


def pos_w(t):
    R_cw, t_cw = pose(t)
    return -(R_cw.T @ t_cw)


def imu_at(t, h=1e-3):
    a_w = (pos_w(t + h) - 2.0 * pos_w(t) + pos_w(t - h)) / (h * h)
    R0 = pose(t)[0].T
    R1 = pose(t + h)[0].T
    dR = R0.T @ R1
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                  dR[1, 0] - dR[0, 1]]) * 0.5 / h
    return w.astype(np.float32), (R0.T @ (a_w - G)).astype(np.float32)


class Renderer:
    """Frames in order from one generator: the texture first, then each
    frame's noise (JAX renders them all up front in the same order)."""

    def __init__(self):
        self.rng = np.random.default_rng(7)
        self.tex = sr.block_texture(self.rng, block=10)
        self.frames: list = []

    def __getitem__(self, i):
        while len(self.frames) <= i:
            t = len(self.frames) / FPS
            R_cw, t_cw = pose(t)
            img = sr.render_plane(R_cw, t_cw, np.asarray(K4), HW, self.tex, tex_scale=60.0)
            img += self.rng.normal(0, 1.5, img.shape).astype(np.float32)
            self.frames.append(np.clip(img, 0, 255).astype(np.uint8))
        return self.frames[i]


def imu_samples(i: int) -> list:
    """The samples (tm, gyro, acc) of ((i-1)/FPS, i/FPS], read at each
    interval's midpoint."""
    if i == 0:
        return []
    dt_i = 1.0 / IMU_HZ
    t0, t1 = (i - 1) / FPS, i / FPS
    out = []
    k = 1
    while t0 + k * dt_i <= t1 + 1e-9:
        tm = t0 + k * dt_i
        out.append((tm, *imu_at(tm - 0.5 * dt_i)))
        k += 1
    return out


def measure_rows(warmup: int, measure: int, capF: int) -> list:
    """Per measured frame warmup..warmup+measure-1, its interval's packed
    rows (capF, 8) [acc gyr dt ok] by the reference's midpoint scheme
    (JAX's staging, drive_vi_chain_ablation.py:97-113)."""
    from ...pipeline import inertial_system

    dt_i = 1.0 / IMU_HZ
    imu_all = []
    tcur = (warmup - 1) / FPS
    while tcur + dt_i <= (warmup + measure - 1) / FPS + 1e-9:
        tcur += dt_i
        w, a = imu_at(tcur - 0.5 * dt_i)
        imu_all.append((tcur, w, a))
    out = []
    for i in range(warmup, warmup + measure):
        t1, t0 = i / FPS, (i - 1) / FPS
        take = [s for s in imu_all if t0 < s[0] <= t1]
        steps = inertial_system.reference_imu_steps(take, t0, t1)
        out.append(inertial_system.pack_imu_rows(steps, capF))
    return out


def warm_up(sys_, frames, p, dev, cap: int):
    """Feed frames (with their IMU samples) until at least `MIN_WARMUP`
    frames are in and the IMU is initialized, or `cap` frames; returns
    (frames fed, the frame at which the IMU initialized or None)."""
    import torch
    from ...features.extractor import extract

    imu_frame = None
    i = 0
    while i < cap and (i < MIN_WARMUP or imu_frame is None):
        for s in imu_samples(i):
            sys_.grab_imu(*s)
        sys_.track_monocular(None, ts=i / FPS, features=extract(
            torch.from_numpy(frames[i]).to(dev), p))
        if imu_frame is None and sys_.imu_initialized:
            imu_frame = i
        i += 1
    return i, imu_frame


class Chains:
    """The three chains on one warmed System; `run_x(lo, hi)` feeds measured
    frames lo..hi-1 from the warmed state and leaves its last output in
    `self.sync`."""

    def __init__(self, sys_, p, dev_frames, rows, n_rows):
        import torch
        from ...solver import vi_pose_opt as vpo
        self.sys_, self.p, self.frames, self.rows, self.n_rows = sys_, p, dev_frames, rows, n_rows
        self.m0, self.view0 = sys_.map, sys_.view
        self.Rwb0, self.pwb0 = sys_.last_body or sys_._cam_to_body(sys_.R_cur, sys_.t_cur)
        self.vel0, self.bias0 = sys_.vel, sys_.bias
        self.prior0 = sys_.frame_prior or vpo.VIPosePrior(
            Rwb=self.Rwb0, pwb=self.pwb0, vel=self.vel0, bias=self.bias0,
            H=torch.eye(15, device=self.vel0.device))
        self.cam = sys_.cam_params
        self.sync = None

    def _track(self, m, ff, Rg, tg):
        from ...pipeline import tracking
        tr = tracking.track_local_map(m, ff, Rg, tg, "pinhole", self.cam, HW,
                                      self.p.scale_factor, self.p.n_levels, radius_th=4.0,
                                      view=self.view0)
        return tr, tracking.update_point_stats(m, tr)

    def run_a(self, lo, hi):
        from ...features.extractor import extract
        from ...ops import lie
        s = self.sys_
        m, R_prev, t_prev, R_cur, t_cur = self.m0, s.R_prev, s.t_prev, s.R_cur, s.t_cur
        for n in range(lo, hi):
            ff = extract(self.frames[n], self.p)
            Rpi, tpi = lie.se3_inverse(R_prev, t_prev)
            Rv, tv = lie.se3_compose(R_cur, t_cur, Rpi, tpi)
            Rg, tg = lie.se3_compose(Rv, tv, R_cur, t_cur)
            tr, m = self._track(m, ff, Rg, tg)
            R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, tr.R, tr.t
        self.sync = (R_cur, t_cur)

    def run_b(self, lo, hi):
        from ...features.extractor import extract
        from ...ops import imu as imu_ops
        s = self.sys_
        m, Rwb, pwb, vel = self.m0, self.Rwb0, self.pwb0, self.vel0
        for n in range(lo, hi):
            ff = extract(self.frames[n], self.p)
            preF = s._preint_rows(self.rows[n], self.n_rows[n], self.bias0)
            R2, p2, v2 = imu_ops.predict_state(Rwb, pwb, vel, self.bias0, preF, s.gravity)
            Rg, tg = s._body_to_cam(R2, p2)
            tr, m = self._track(m, ff, Rg, tg)
            Rwb, pwb, vel = (s.Rbc @ tr.R).T, p2, v2
        self.sync = (Rwb, pwb)

    def run_c(self, lo, hi):
        from ...features.extractor import extract
        s = self.sys_
        m, Rwb, pwb, vel, prior = self.m0, self.Rwb0, self.pwb0, self.vel0, self.prior0
        try:
            for n in range(lo, hi):
                ff = extract(self.frames[n], self.p)
                s.map = m
                m, out = s._vi_track_step(ff, self.rows[n], self.n_rows[n], 0, False, True,
                                          4.0, prior, Rwb, pwb, vel, self.bias0)
                Rwb, pwb, vel, prior = out.Rwb, out.pwb, out.vel, out.prior
        finally:
            s.map = self.m0
        self.sync = (Rwb, pwb)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m orbslam3_tpu_torch.tools.drives.drive_vi_chain_ablation")
    add_device_arg(ap)
    ap.add_argument("--cap", type=int, default=200,
                    help="most warm-up frames while waiting for the IMU initialization")
    ap.add_argument("--measure", type=int, default=36,
                    help="measured frames per chain, the first 6 to settle (JAX: 36)")
    args = ap.parse_args(argv)

    import torch

    from ...features.extractor import OrbParams
    from ...pipeline import inertial_system, system as base_sys
    from ...slam_map import state as mapstate
    from ...utils import sync_census

    dev = device_of(ap, args.device)
    print("device:", device_name(dev), flush=True)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    p = OrbParams(n_features=1200, n_levels=8)
    cfg = base_sys.SlamConfig(
        cam_model="pinhole", cam_params=K4, image_hw=HW, orb=p,
        min_init_matches=60, min_track_inliers=20,
        max_frames_between_kf=6)
    icfg = inertial_system.InertialConfig(
        imu_freq=IMU_HZ, init_time_s=2.0, init_min_kfs=6,
        refine_time_s=5.0, refine2_time_s=1e9)
    sys_ = inertial_system.InertialSystem(cfg, icfg, device=dev)
    frames = Renderer()

    t0 = time.time()
    warmup, imu_frame = warm_up(sys_, frames, p, dev, args.cap)
    ready = sys_.imu_initialized and sys_.state == base_sys.OK
    if ready:
        print(f"warm-up: {warmup} frames in {time.time() - t0:.0f} s; initialized at frame "
              f"{sys_.init_info.get('frame') if sys_.init_info else None}, IMU initialized "
              f"at frame {imu_frame}", flush=True)
    else:
        print(f"warm-up: IMU NOT initialized within {warmup} frames (state {sys_.state}); "
              f"the chains below run on the visual state", flush=True)

    measure = args.measure
    rows_np = measure_rows(warmup, measure, icfg.max_imu_per_frame)
    n_rows = [inertial_system._n_rows(r) for r in rows_np]
    rows = [mapstate._upload(r[:k], dev) for r, k in zip(rows_np, n_rows)]
    dev_frames = [torch.from_numpy(frames[warmup + n]).to(dev) for n in range(measure)]
    sync()
    ch = Chains(sys_, p, dev_frames, rows, n_rows)

    def timed(fn):
        fn(0, SETTLE)
        sync()
        t1 = time.perf_counter()
        fn(SETTLE, measure)
        sync()
        return (measure - SETTLE) / (time.perf_counter() - t1)

    fa = timed(ch.run_a)
    fb = timed(ch.run_b)
    fc = timed(ch.run_c)
    n_pre = statistics.mean(n_rows)
    print(f"\nA extract+track            : {fa:7.1f} fps "
          f"({1e3 / fa:6.2f} ms/frame)")
    print(f"B + preint({n_pre:.0f}) + predict   : {fb:7.1f} fps "
          f"({1e3 / fb:6.2f} ms/frame)")
    print(f"C fused _vi_track_step     : {fc:7.1f} fps "
          f"({1e3 / fc:6.2f} ms/frame)")
    print(f"preint+predict cost: {1e3 / fb - 1e3 / fa:6.2f} ms/frame; "
          f"retry-cond + VI opt cost: {1e3 / fc - 1e3 / fb:6.2f} ms/frame")
    reads = None
    if on_card:
        reads = {}
        for name, fn in (("A", ch.run_a), ("B", ch.run_b), ("C", ch.run_c)):
            found: list = []
            with sync_census._sync_warnings(found):
                fn(0, SETTLE)
            reads[name] = len(found) / SETTLE
        print(f"blocking reads per frame: A {reads['A']:.2f}, B {reads['B']:.2f}, "
              f"C {reads['C']:.2f}", flush=True)
    else:
        print("blocking reads per frame: not measured (no CUDA device)", flush=True)
    return 0 if ready else 1


if __name__ == "__main__":
    raise SystemExit(main())
