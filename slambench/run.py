"""Run one cell of the benchmark once and print its result line.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in the checkout's `BENCHMARK.json`.  Its
configuration (`configs/<config>.json`) names the port's preset, the system
that runs it (`systems/<system>.py`) and the numbers the harness holds it
to; its traffic (`traffic/<traffic>.json`) is the sequence's data: its
generator (`sequences/<generator>.py`), path, rates, texture, noise,
frames, warm-up, the frames the reference checks and the traced slice.
The run:

1. makes the sequence from the seed (the plane's generator renders it on
   the card and copies it to host memory), builds the port's System from
   the preset, and feeds it frames until the traffic's warm-up is met (the System
   initialized, enough keyframes, in the inertial cell the IMU
   initialized): that is set-up, `setup_s` from process start;
2. feeds the next frames back to back, each after the previous one returned
   its pose (`grab_imu` for each 200 Hz sample of the interval, then the
   system's entry), for `--seconds`, and at least through the frames the
   checks draw from: `fps` is the frames over the
   window's seconds (each frame's latency, the call until the pose is back
   on the host, goes to the per-layer readers);
3. with `--trace 1` the window runs with ranges around the stages that the
   cell's per-layer metrics name (host clock), then a profiled slice of the
   next frames (CUDA activity only) and a few extractions under the
   profiler, and each per-layer metric's reader (`metrics/<name>.py`) takes
   its number from them;
4. checks that no module of JAX or of the JAX package was loaded, frees the
   System, and holds what the timed path produced against the plain
   reference (`reference.py`, `optimum.py`, `checks.py`): `correct`.

It exits with 2 and prints no result without a CUDA device, and with 3 if
JAX was loaded.  `--control tf32` runs the program with TF32 matmuls, the
precision below the one the configuration states, to show that the
comparison fails it; a benchmark run never passes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_T_IMPORT = time.time()


def process_age() -> float:
    """Seconds since this process started (from /proc; the import time of
    this module where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell `name` of `BENCHMARK.json` with its configuration, traffic
    and metric entries."""
    manifest = _json(ROOT, "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def mine(m):
        return name in m.get("workloads", [name])
    return dict(cell=cell, config=_json(HERE, "configs", cell["config"] + ".json"),
                traffic=_json(HERE, "traffic", cell["traffic"] + ".json"),
                end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
                per_layer=[m for m in manifest["per_layer"] if mine(m)])


def load_metric(name: str):
    """The reader module `metrics/<name>.py`."""
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Frame:
    index: int
    seconds: float
    ok: bool
    keyframe: bool
    imu_stage: bool


class Extraction(NamedTuple):
    """One `extract` call: the image tensor it was given (None outside the
    frames `desc_wrong` samples) and its FeatureFrame."""
    image: Any
    ff: Any


class Capture:
    """Keeps what the timed path produced in chosen frames, by reference
    (the port builds new tensors and writes none in place): every extraction
    of the frame in call order with the image it was given, the pose-only
    optimization's points, keypoints and answer (`solver/pose_opt.
    pose_optimization`, inside tracking), the window BA's problem and answer
    (`solver/ba_grid.bundle_adjust_grid`), the VI pose optimizations'
    arguments and answers (`solver/vi_pose_opt`), every inertial-only
    initialization (`solver/inertial.inertial_only_init`) with the keyframes
    its factors join, and a pair's association and its refinement
    (`features/stereo.stereo_match`, `refine_disparity`) with their
    arguments."""

    def __init__(self, sys_):
        self.sys = sys_
        self.ff_frames, self.track_frames = set(), set()
        self.ba_frames, self.vi_frames = set(), set()
        self.ff, self.track, self.ba, self.vi, self.init = {}, {}, [], [], []
        self.stereo = {}
        self.profile_extract = None      # a list: profile every extraction into it

    def tracked(self, i: int):
        """The FeatureFrame that tracking used in frame i: every System
        extracts the image it tracks first (a pair's left, then its right),
        which `checks` confirms where the association names its left
        features."""
        return self.ff[i][0].ff

    def install(self, ranges):
        import torch
        from orbslam3_tpu_torch.features import extractor, stereo
        from orbslam3_tpu_torch.solver import ba_grid, inertial, pose_opt, vi_pose_opt
        extract, pose = extractor.extract, pose_opt.pose_optimization
        ba, init = ba_grid.bundle_adjust_grid, inertial.inertial_only_init
        vi_kf, vi_lf = vi_pose_opt.vi_pose_optimization, vi_pose_opt.vi_pose_optimization_last_frame

        def extract_cap(*args, **kwargs):
            if self.profile_extract is None:
                out = extract(*args, **kwargs)
            else:
                from . import trace
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    with torch.profiler.record_function("extract"):
                        out = extract(*args, **kwargs)
                    torch.cuda.synchronize()
                rows = trace.range_table(trace.chrome_trace(prof), ("extract",))[0]
                self.profile_extract.append(rows["extract"][2] / 1e3)
            if self.sys.frame_id in self.ff_frames or self.sys.frame_id in self.vi_frames:
                # the image only where `desc_wrong` reads it: each one kept
                # adds to the peak the window reads
                image = args[0] if args else kwargs["img"]
                self.ff.setdefault(self.sys.frame_id, []).append(
                    Extraction(image if self.sys.frame_id in self.ff_frames else None, out))
            return out

        def stereo_cap(fn, key):
            sig = inspect.signature(fn)

            def cap(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.sys.frame_id in self.ff_frames:
                    bound = sig.bind(*args, **kwargs)
                    bound.apply_defaults()
                    self.stereo.setdefault(self.sys.frame_id, {})[key] = (bound.arguments, out)
                return out
            return cap

        def pose_cap(R0, t0, X, uv, inv_sigma2, valid, *args, **kwargs):
            out = pose(R0, t0, X, uv, inv_sigma2, valid, *args, **kwargs)
            if self.sys.frame_id in self.track_frames:
                self.track[self.sys.frame_id] = (R0, t0, X, uv, valid, out)
            return out

        def ba_cap(prob, *args, **kwargs):
            out = ba(prob, *args, **kwargs)
            if self.sys.frame_id in self.ba_frames:
                self.ba.append((self.sys.frame_id, prob, out))
            return out

        def vi_cap(fn, kind):
            def cap(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.sys.frame_id in self.vi_frames:
                    self.vi.append(dict(frame=self.sys.frame_id, kind=kind, args=args,
                                        out=out, kf_ts=self.sys.last_kf_ts))
                return out
            return cap

        def init_cap(*args, **kwargs):
            out = init(*args, **kwargs)
            self.init.append(dict(args=args, kwargs=kwargs, out=out,
                                  pairs=list(self.sys.preint_kf_pairs),
                                  kf_ts=self.sys.map.kf_ts))
            return out

        ranges.replace(extractor, "extract", extract_cap)
        ranges.replace(pose_opt, "pose_optimization", pose_cap)
        ranges.replace(ba_grid, "bundle_adjust_grid", ba_cap)
        ranges.replace(vi_pose_opt, "vi_pose_optimization", vi_cap(vi_kf, "lastkf"))
        ranges.replace(vi_pose_opt, "vi_pose_optimization_last_frame", vi_cap(vi_lf, "lastframe"))
        ranges.replace(inertial, "inertial_only_init", init_cap)
        ranges.replace(stereo, "stereo_match", stereo_cap(stereo.stereo_match, "match"))
        ranges.replace(stereo, "refine_disparity", stereo_cap(stereo.refine_disparity, "refine"))


def warm_up(sys_, feed, seq, spec: dict) -> int:
    """Feed frames from the start until the traffic's warm-up is met;
    returns the next frame's index."""
    from orbslam3_tpu_torch.pipeline import system

    until = spec.get("until")
    for i in range(min(spec["max_frames"], seq.n)):
        feed(sys_, seq, i)
        if i + 1 >= spec["min_frames"] and sys_.state == system.OK and \
                sys_.n_kf_host >= spec["min_keyframes"] and (until is None or getattr(sys_, until)):
            return i + 1
    raise RuntimeError(f"warm-up not met within {spec['max_frames']} frames: state {sys_.state}, "
                       f"{sys_.n_kf_host} keyframes" + (f", {until} {getattr(sys_, until)}"
                                                        if until else ""))


def run_frames(sys_, feed, seq, i: int, seconds: float, sync, ranges=None,
               stop_frames=None, min_frames: int = 0):
    """Frames back to back from `i` until `seconds` have passed and at least
    `min_frames` frames have run (or until `stop_frames(frames)` says so);
    returns (frames, poses, seconds)."""
    log, poses = [], []
    t_start = time.perf_counter()
    while True:
        if i >= seq.n:
            raise RuntimeError(f"the sequence ran out of frames at {seq.n}: the window needs more "
                               "(traffic 'frames')")
        if ranges is not None:
            ranges.frame = i
        n_kf, stage = sys_.n_kf_host, getattr(sys_, "last_imu_stage_frame", -1)
        t0 = time.perf_counter()
        _, pose = feed(sys_, seq, i)
        t1 = time.perf_counter()
        log.append(Frame(i, t1 - t0, pose is not None, sys_.n_kf_host > n_kf,
                         getattr(sys_, "last_imu_stage_frame", -1) != stage))
        poses.append(pose)
        i += 1
        if (stop_frames is None and t1 - t_start >= seconds and len(log) >= min_frames) or \
                (stop_frames is not None and stop_frames(log)):
            sync()
            return log, poses, time.perf_counter() - t_start


def end_to_end(log, window_s: float) -> dict:
    """`fps`: every frame of the window over the window's seconds."""
    return dict(fps=len(log) / window_s)


def frame_notes(log) -> dict:
    """Host medians of the window's tracked and keyframe frames (ms) and
    the keyframe frames' share: what tells the host's speed from the mix."""
    kf = [f.seconds * 1e3 for f in log if f.keyframe]
    tr = [f.seconds * 1e3 for f in log if not f.keyframe and not f.imu_stage]
    return dict(tracked_ms_p50=float(np.median(tr)) if tr else None,
                kf_ms_p50=float(np.median(kf)) if kf else None,
                kf_share=len(kf) / max(len(log), 1))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
             control: str | None = None, overrides: dict | None = None) -> dict:
    """One run of a cell (`load_cell`'s dict, which a test may shrink with
    preset `overrides`); returns the result line's dict."""
    import torch

    from . import sequences
    from . import trace as tr

    config, traffic = spec["config"], spec["traffic"]
    torch.set_num_threads(4)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # the port sets its float32 policy when it is imported: import it first
    import orbslam3_tpu_torch  # noqa: F401
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")

    seq = sequences.load(traffic.get("generator", "plane")).make(traffic, config, seed, dev)
    ranges = tr.Ranges()
    readers = {m["name"]: load_metric(m["name"]) for m in spec["per_layer"]} if trace else {}
    try:
        for r in readers.values():
            for module, attr, name in getattr(r, "RANGES", ()):
                if name not in ranges.times:
                    ranges.wrap(module, attr, name)
        return _run(spec, seed, seconds, trace, seq, ranges, readers, dev, sync, overrides or {})
    finally:
        ranges.restore()


def _run(spec, seed, seconds, trace, seq, ranges, readers, dev, sync, overrides) -> dict:
    import torch

    from . import checks, systems
    from . import trace as tr

    config, traffic = spec["config"], spec["traffic"]
    cuda = dev.type == "cuda"
    system = systems.load(config["system"])
    feed = system.feed
    sys_ = system.build(config, dev, seed % (2 ** 31), overrides)
    cap = Capture(sys_)
    cap.install(ranges)
    i0 = warm_up(sys_, feed, seq, traffic["warmup"])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # the frames whose output the reference checks, drawn from the seed
    # among the window's first ones
    chk = traffic["check"]
    rng = np.random.default_rng(seed % (2 ** 63))
    picks = sorted(int(x) for x in rng.choice(chk["from_first"], chk["frames"], replace=False))
    cap.ff_frames = {i0 + p for p in picks}
    cap.track_frames = set(cap.ff_frames) if "pose_gap_px" in config["checks"] else set()
    # every window BA and VI pose optimization of the window's first frames
    cap.ba_frames = set(range(i0, i0 + chk.get("keyframes_from_first", 0)))
    cap.vi_frames = set(range(i0, i0 + chk["from_first"]))

    setup_s = process_age()
    ranges.on = trace
    # the window holds at least the frames the checks draw from, however
    # slow the host: a check with nothing to read fails the run
    log, poses, window_s = run_frames(
        sys_, feed, seq, i0, seconds, sync, ranges,
        min_frames=max(chk["from_first"], chk.get("keyframes_from_first", 0)))
    ranges.on = False
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    ctx = dict(frames=log, ranges=ranges.times)
    device_out = dict(platform="gpu" if cuda else "cpu",
                      kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                      count=1, memory_peak_bytes=int(peak))
    breakdown = None
    if trace:
        ctx.update(_traced_slices(sys_, feed, seq, i0 + len(log), traffic["trace"], cap, sync,
                                  tr, config))
        device_out.update(busy_s=ctx["slice"]["busy_s"], window_s=ctx["slice"]["wall_s"])
        breakdown = dict(
            device_ops=[[n, s] for n, s in ctx["slice"]["by_name"].most_common(10)],
            idle_gaps=[[f"before {n}", s] for s, n in sorted(ctx["slice"]["gaps"], reverse=True)[:10]])

    # what the reference needs, to the host; then the System goes
    produced = checks.collect(sys_, cap, seq, log, poses, i0, seed, chk)
    del sys_, cap
    if cuda:
        torch.cuda.empty_cache()
    found = checks.loaded_jax()
    if found:
        raise JaxLoaded(found)
    t_check = time.perf_counter()
    verdict = checks.judge(produced, seq, config)
    t_check = time.perf_counter() - t_check

    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(end_to_end(log, window_s), setup_s=setup_s)
        metrics = {m["name"]: dict(value=float(values[m["name"]]), unit=m["unit"])
                   for m in spec["end_to_end"]}
    failed = sum(not f.ok for f in log)
    out = dict(correct=verdict["correct"], attempted=len(log), failed=failed, metrics=metrics,
               device=device_out)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["notes"] = dict(frames=len(log), keyframes=sum(f.keyframe for f in log),
                        **frame_notes(log),
                        imu_stage_frames=sum(f.imu_stage for f in log), first_frame=i0,
                        init=produced["init"], window_s=window_s, setup_s=setup_s,
                        power=ctx.get("power"), readings=verdict["readings"], check_s=t_check)
    out["checks"] = verdict["checks"]
    return out


def _traced_slices(sys_, feed, seq, i, spec: dict, cap, sync, tr, config) -> dict:
    """The profiled slice (CUDA activity only) over the next frames, then a
    few extractions under the profiler alone."""
    import torch
    from . import kernels

    cap.ff_frames |= set(range(i, i + spec["max_frames"]))

    def enough(log):
        return len(log) >= spec["max_frames"] or (
            len(log) >= spec["min_frames"] and sum(f.keyframe for f in log) >= spec["min_keyframes"])

    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        log, _, wall = run_frames(sys_, feed, seq, i, 0.0, sync, stop_frames=enough)
    dev = tr.device_summary(tr.chrome_trace(prof))
    del prof
    num = config["preset_numbers"]
    orb = num["orb"]
    bound_s = []
    for f in log:
        # one `orb_describe` launch per extraction
        for _, ff in cap.ff.get(f.index, ()):
            xy = ff.xy.cpu().numpy()
            k, hw = kernels.atlas_coords(xy, ff.octave.cpu().numpy(), num["image_hw"],
                                         orb["n_levels"], orb["scale_factor"])
            bound_s.append(kernels.orb_describe_bytes(k, ff.angle.cpu().numpy(), hw)
                           / kernels.PEAK_BYTES_PER_S)
    cap.profile_extract = []
    i += len(log)
    run_frames(sys_, feed, seq, i, 0.0, sync,
               stop_frames=lambda lg: len(lg) >= spec["extract_frames"])
    extract = cap.profile_extract
    cap.profile_extract = None
    dev.update(frames=len(log), keyframes=sum(f.keyframe for f in log), wall_s=wall,
               describe_bound_s=bound_s)
    return dict(slice=dev, extract_device_s=extract, power=_power_limit())


class JaxLoaded(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None)
    args = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".slambench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    spec = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"slambench: the cell needs {spec['cell']['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(spec, args.seed, args.seconds, bool(args.trace), control=args.control)
    except JaxLoaded as e:
        print(f"slambench: loaded after the window: {', '.join(e.args[0])}", file=sys.stderr)
        return 3
    n = out["notes"]
    print(f"window: {n['frames']} frames in {n['window_s']:.3f} s ({n['keyframes']} keyframe "
          f"frames); set-up {n['setup_s']:.2f} s to frame "
          f"{n['first_frame']} ({n['init']}); {n['power'] or ''}", file=sys.stderr)
    for name, v in n["readings"].items():
        print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
