"""Profile the seeded keyframe drive's steps under torch.profiler on one GPU.

    python -m orbslam3_tpu_torch.utils.profile_keyframe [--frames 12] [--out DIR]
    python -m orbslam3_tpu_torch.utils.profile_keyframe --inertial [--out DIR]
    python -m orbslam3_tpu_torch.utils.profile_keyframe --async [--out DIR]

Seeds the default-size scene (`seeded_scene.SceneConfig()`), runs the drive
once to warm up, then profiles it again over `--frames` tracked frames
(one keyframe step per 6).  Each stage of the keyframe step is a profiler
range: `insert_kf` (with `triangulate_vs_neighbors` inside it), `cull`,
`local_ba` (with `solve_psd_blocked` inside it), `view` and
`post_ba_stages`, beside `track_frame` for the tracked frames.  Prints,
per keyframe step, each range's host milliseconds, device milliseconds
(the kernels launched inside it) and kernel launches, then the device's
busy share over the profiled drive, and writes the Chrome trace to
`DIR/keyframe_trace.json`.

`--inertial` drives the mono-inertial System on `imu_scene`'s 128 frames
instead and profiles one frame of each kind (`imu_scene.frame_kind`: the
tracked frame before the IMU initialization, the keyframe frame, the
IMU-init frame, the LastKeyFrame and LastFrame tracked frames, the inertial
keyframe frame), with the inertial stages as ranges: `preintegrate`,
`track_local_map`, `vi_pose_optimization` (LastKeyFrame),
`vi_pose_optimization_last_frame`, `solve_psd` / `solve_psd_blocked`,
`insert_kf`, `local_ba`, `vi_bundle_adjust`, `inertial_only_init`,
`post_ba_stages`.  Prints the range table per kind and writes it to
`DIR/inertial_profile.json`.

`--async` compares phase 6 of `chip_smoke.py` (bench.py's 78 frames through
`System.track_monocular`) synchronous, with `async_mapping`, and with
`async_mapping` and `enable_loop_closing` (phase 9a), `--rounds` times in
alternating order (sync, async, async + loop closing, then backwards).  Each drive
synchronises after every frame, as `seeded_scene.drive_system` does, and
times every frame on the host clock; then one drive per mode runs again,
unsynchronised, for its wall time alone; then one drive per mode with every
frame under the profiler (CUDA activity) and
`torch.cuda.set_sync_debug_mode("warn")`.  Prints, per mode and frame kind
(tracked frame, tracked frame that merged the pending chain at its poll,
keyframe frame), the frames, the host-clock median of each timed drive, and
the profiled drive's median kernels, device ms and blocking reads; writes it
to `DIR/async_profile.json`.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import time

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ranged(name, fn):
    import torch

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _instrument():
    """Wrap the stages in profiler ranges (module attributes, so that the
    callers' lookups at call time find the wrappers)."""
    from ..ops import smallsolve
    from ..pipeline import frame_step, mapping, system
    for mod, attr, name in ((system, "insert_kf", "insert_kf"), (system, "cull", "cull"),
                            (system, "local_ba", "local_ba"), (system, "local_view", "view"),
                            (system, "post_ba_stages", "post_ba_stages"),
                            (mapping, "triangulate_vs_neighbors", "triangulate_vs_neighbors"),
                            (smallsolve, "solve_psd_blocked", "solve_psd_blocked"),
                            (frame_step, "track_frame", "track_frame")):
        setattr(mod, attr, _ranged(name, getattr(mod, attr)))
    return ("insert_kf", "triangulate_vs_neighbors", "cull", "local_ba",
            "solve_psd_blocked", "view", "post_ba_stages", "track_frame")


def range_table(trace: dict, names) -> tuple[dict, float, int]:
    """From a Chrome trace of torch.profiler: per range name, [calls, host
    ms, device ms, kernel launches], where a range owns the device work
    (kernels, copies, sets) whose launching runtime call lies inside it on
    the host.  Also returns the device's busy ms and kernel count over the
    whole trace."""
    ev = trace["traceEvents"]
    dev = {e["args"]["correlation"]: e for e in ev if e.get("cat") in _DEVICE_CATS}
    calls = sorted((e["ts"], dev[e["args"]["correlation"]]) for e in ev
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("args", {}).get("correlation") in dev)
    starts = [c[0] for c in calls]
    rows = {}
    for e in ev:
        if e.get("cat") != "user_annotation" or e["name"] not in names:
            continue
        owned = [d for _, d in calls[bisect.bisect_left(starts, e["ts"]):
                                     bisect.bisect_right(starts, e["ts"] + e["dur"])]]
        r = rows.setdefault(e["name"], [0, 0.0, 0.0, 0])
        r[0] += 1
        r[1] += e["dur"] / 1e3
        r[2] += sum(d["dur"] for d in owned) / 1e3
        r[3] += sum(d["cat"] == "kernel" for d in owned)
    busy = sum(e["dur"] for e in dev.values()) / 1e3
    return rows, busy, sum(e["cat"] == "kernel" for e in dev.values())


class DeviceWork:
    """A context manager that profiles what runs inside it on the current
    CUDA device: afterwards `launches` (kernels), `device_ms` (kernels,
    copies and sets) and, with `ranges`, the range table of those names
    (CPU and CUDA activities; without ranges CUDA alone, a smaller trace).
    The last one entered is `DeviceWork.last`."""
    last = None

    def __init__(self, kind=None, ranges=()):
        self.kind, self.ranges, self.frame = kind, tuple(ranges), None
        self.launches = self.device_ms = self.table = None

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.ranges:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        DeviceWork.last = self
        return self

    def __exit__(self, *exc):
        import tempfile
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        work = [e for e in trace["traceEvents"] if e.get("cat") in _DEVICE_CATS]
        self.launches = sum(e["cat"] == "kernel" for e in work)
        self.device_ms = sum(e["dur"] for e in work) / 1e3
        if self.ranges:
            self.table = range_table(trace, self.ranges)[0]
        self._prof = None
        return False


def kernel_durations(fn, names, runs: int = 50) -> tuple[dict, int]:
    """Run `fn` `runs` times under torch.profiler on the current CUDA device
    and read the kernel records of the Chrome trace: per name in `names`,
    the device durations in microseconds of the kernels whose name contains
    it; also the number of kernels of any name launched per run."""
    import tempfile

    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    return ({n: [e["dur"] for e in kernels if n in e["name"]] for n in names},
            len(kernels) // runs)


def profile(cfg, dev, out_dir: str, card: str) -> dict:
    """Warm up, then profile the drive over cfg.track_frames on `dev`."""
    import torch
    from . import seeded_scene as scene

    names = _instrument()
    frames = scene.render_frames(cfg)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def drive():
        m, bank, view = scene.seed_map(cfg, frames, dev)
        sync()
        t0 = time.perf_counter()
        out = scene.track_with_keyframes(cfg, m, bank, view, frames, dev)
        sync()
        return out, time.perf_counter() - t0

    drive()                                       # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        (_, _, _, _, secs, steps), wall = drive()
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "keyframe_trace.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        rows, busy_ms, n_launch = range_table(json.load(f), names)
    print(f"card: {card}")
    print(f"profiled drive: {len(secs)} tracked frames, {len(steps)} keyframe steps, wall "
          f"{wall * 1e3:.1f} ms under the profiler; device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}%), {n_launch} kernel launches")
    per = {"track_frame": len(secs)}
    print(f"{'range':26s} {'calls':>5s} {'host ms':>10s} {'device ms':>10s} "
          f"{'launches':>9s}   per tracked frame / per keyframe step")
    table = {}
    for name in names:
        if name not in rows:
            continue
        c, host, devms, launches = rows[name]
        k = per.get(name, len(steps))
        table[name] = dict(calls=c, host_ms=host / k, device_ms=devms / k,
                           launches=launches / k)
        print(f"{name:26s} {c:5d} {host / k:10.2f} {devms / k:10.2f} {launches / k:9.0f}")
    print("keyframe step times under the profiler (host clock, synchronised): " +
          ", ".join(f"{s.seconds * 1e3:.1f}" for s in steps) + " ms")
    result = {"card": card, "wall_ms": wall * 1e3, "busy_ms": busy_ms,
              "launches": n_launch, "per_call": table,
              "kf_step_ms": [s.seconds * 1e3 for s in steps]}
    with open(os.path.join(out_dir, "keyframe_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def _instrument_inertial():
    """Wrap the inertial stages in profiler ranges (module attributes)."""
    from ..ops import imu, smallsolve
    from ..pipeline import system, tracking
    from ..solver import inertial, vi_ba, vi_pose_opt
    spec = ((imu, "preintegrate"), (tracking, "track_local_map"),
            (vi_pose_opt, "vi_pose_optimization"),
            (vi_pose_opt, "vi_pose_optimization_last_frame"), (smallsolve, "solve_psd"),
            (smallsolve, "solve_psd_blocked"), (system, "insert_kf"), (system, "local_ba"),
            (vi_ba, "vi_bundle_adjust"), (inertial, "inertial_only_init"),
            (system, "post_ba_stages"))
    for mod, attr in spec:
        setattr(mod, attr, _ranged(attr, getattr(mod, attr)))
    return tuple(attr for _, attr in spec)


def profile_inertial(dev, out_dir: str, card: str) -> dict:
    """One profiled frame of each kind of `imu_scene`'s inertial drive, with
    the inertial stages' range table."""
    import torch
    from . import imu_scene as scene

    names = _instrument_inertial()
    cfg = scene.InertialScene()
    frames = scene.render_frames(cfg)
    done = {}

    def wrap(i, sys_):
        kind = scene.expected_kind(sys_, i)
        if kind is None or kind in done or i < 10:
            return None
        return DeviceWork(kind, ranges=names)

    def on_frame(i, sys_, kind):
        w = DeviceWork.last
        DeviceWork.last = None
        if w is not None and w.kind == kind:
            w.frame = i
            done[kind] = w

    sys_, d = scene.drive(cfg, frames, dev, sync=torch.cuda.synchronize, wrap=wrap,
                          on_frame=on_frame)
    print(f"card: {card}")
    result = {"card": card, "kinds": {}}
    for kind, w in done.items():
        print(f"{kind} (frame {w.frame}, {d.seconds[w.frame] * 1e3:.1f} ms under the "
              f"profiler): {w.launches} kernels, {w.device_ms:.2f} ms of device time")
        print(f"  {'range':34s} {'calls':>5s} {'host ms':>10s} {'device ms':>10s} {'launches':>9s}")
        for name in names:
            if name in w.table:
                c, host, devms, n = w.table[name]
                print(f"  {name:34s} {c:5d} {host:10.2f} {devms:10.2f} {n:9d}")
        result["kinds"][kind] = dict(frame=w.frame, launches=w.launches, device_ms=w.device_ms,
                                     host_ms=d.seconds[w.frame] * 1e3, ranges=w.table)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "inertial_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


ASYNC_MODES = {"sync": {}, "async": dict(async_mapping=True),
               "async + loop closing": dict(async_mapping=True, enable_loop_closing=True)}


def _async_drive(cfg, frames, dev, mode: str, per_frame_sync=True, profiled=False):
    """One drive of phase 6's frames; per frame (kind, host ms, kernels,
    device ms, blocking reads' call sites), the last three with `profiled`
    only.  Returns (records, wall seconds)."""
    import torch
    from ..pipeline import system
    from . import seeded_scene as scene
    from .sync_census import _sync_warnings

    sys_ = system.System(dataclasses.replace(scene.system_config(cfg), **ASYNC_MODES[mode]),
                         device=dev, seed=42)
    sync = torch.cuda.synchronize
    recs = []
    sync()
    wall0 = time.perf_counter()
    for fi in cfg.track_frames:
        was, n_kf = sys_.state, sys_.n_kf_host
        polled = sys_.chain_counts["merged kf at a poll"]
        if per_frame_sync:
            sync()
        work = DeviceWork() if profiled else contextlib.nullcontext()
        found = []
        t0 = time.perf_counter()
        with work:
            with _sync_warnings(found) if profiled else contextlib.nullcontext():
                sys_.track_monocular(frames[fi], fi / 10.0)
            if per_frame_sync:
                sync()
        ms = (time.perf_counter() - t0) * 1e3
        if was != system.OK:
            kind = "initialization"
        elif sys_.n_kf_host > n_kf:
            kind = "keyframe frame"
        elif sys_.chain_counts["merged kf at a poll"] > polled:
            kind = "tracked frame, merged at its poll"
        else:
            kind = "tracked frame"
        recs.append((kind, ms, work.launches if profiled else None,
                     work.device_ms if profiled else None, found))
    sys_.shutdown()
    return recs, time.perf_counter() - wall0


def profile_async(dev, out_dir: str, card: str, rounds: int = 3) -> dict:
    """Phase 6's drive in each of `ASYNC_MODES`, timed, unsynchronised and
    profiled (see the module's docstring)."""
    import statistics

    from . import seeded_scene as scene

    cfg = dataclasses.replace(scene.SceneConfig(), seed_frames=(), track_frames=tuple(range(78)))
    frames = scene.render_frames(cfg)
    modes = tuple(ASYNC_MODES)
    _async_drive(cfg, frames, dev, "sync")          # warm-up
    timed = {m: [] for m in modes}
    for r in range(rounds):
        for mode in (modes if r % 2 == 0 else modes[::-1]):
            timed[mode].append(_async_drive(cfg, frames, dev, mode)[0])
    wall = {m: _async_drive(cfg, frames, dev, m, per_frame_sync=False)[1] * 1e3 for m in modes}
    prof = {m: _async_drive(cfg, frames, dev, m, profiled=True)[0] for m in modes}
    med = statistics.median
    print(f"card: {card}")
    result = {"card": card, "wall_ms_unsynchronised": wall, "modes": {}}
    for mode in modes:
        print(f"{mode}: 78 frames in {wall[mode]:.1f} ms without a per-frame sync")
        kinds = {}
        for kind in dict.fromkeys(r[0] for r in prof[mode]):
            runs = [[r[1] for r in recs if r[0] == kind] for recs in timed[mode]]
            p = [r for r in prof[mode] if r[0] == kind]
            row = dict(frames=[len(x) for x in runs], host_ms=[med(x) for x in runs if x],
                       launches=med(r[2] for r in p), device_ms=med(r[3] for r in p),
                       reads=med(len(r[4]) for r in p),
                       read_sites=collections.Counter(x for r in p for x in r[4]))
            kinds[kind] = row
            print(f"  {kind}: frames {row['frames']}, host-clock medians "
                  + " / ".join(f"{x:.1f}" for x in row["host_ms"]) +
                  f" ms; profiled median {row['launches']} kernels, {row['device_ms']:.2f} ms "
                  f"of device time, {row['reads']} blocking reads; sites over its "
                  f"{len(p)} frames: {dict(row['read_sites'])}")
        result["modes"][mode] = kinds
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "async_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main() -> int:
    import torch
    from . import seeded_scene as scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--inertial", action="store_true")
    ap.add_argument("--async", dest="async_", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.inertial:
        profile_inertial(torch.device("cuda", 0), args.out, card)
        return 0
    if args.async_:
        profile_async(torch.device("cuda", 0), args.out, card, args.rounds)
        return 0
    cfg = dataclasses.replace(scene.SceneConfig(),
                              track_frames=tuple(range(19, 19 + args.frames)))
    profile(cfg, torch.device("cuda", 0), args.out, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
