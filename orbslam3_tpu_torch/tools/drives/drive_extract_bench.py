"""Micro-bench: ORB extraction throughput on one card.

    python -m orbslam3_tpu_torch.tools.drives.drive_extract_bench [n_iters] [--device cuda|cpu]

The port of `tools/drives/drive_extract_bench.py`, with the same
`OrbParams(1200, 8)`, 480x752 frames of a blocky texture with fresh noise
(seed 0), a fresh frame every iteration and `n_iters` (default 60).  Every
frame is on the device before the clock starts.  Measures
`features/extractor.extract` two ways:

  * the dependent chain: each iteration's input is made from the previous
    output (the frame plus 0 x the previous response, as JAX's `carry`), so
    the iterations cannot overlap; host clock over `n_iters` frames with one
    `torch.cuda.synchronize()` at the end;
  * in place of JAX's XLA trace, torch.profiler over 12 more iterations, each
    in its own range: the device time per `extract` (kernels, copies and
    sets launched inside the range, `utils/profile_keyframe.range_table`),
    the five kernels with the most device time, `orb_describe`'s device time
    and its share, and the kernels launched per `extract`.

Where JAX prints "compile+first" the port's first call builds the ORB patch
kernel with nvcc when `orbslam3_tpu_torch/build/` has no copy of it yet.  On
`--device cpu` the device lines say "device time: not measured": no CPU time
stands under a device name.  `main` returns the numbers.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import numpy as np

from .. import add_device_arg, device_name, device_of

HW = (480, 752)
N_PROFILED = 12


def make_frames(iters: int) -> list:
    """JAX's textured uint8 frames: one blocky texture, fresh noise per frame."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (HW[0] // 8, HW[1] // 8))
    tex = np.kron(base, np.ones((8, 8))).astype(np.float32)
    return [np.clip(tex + rng.normal(0, 8, HW), 0, 255).astype(np.uint8)
            for _ in range(iters)]


def device_profile(step, frames, carry) -> dict:
    """`N_PROFILED` chained steps under torch.profiler, one range each: per
    step the device ms; kernel device ms by name; kernels per step."""
    import torch
    from ...utils import profile_keyframe as pk

    names = [f"extract_{i}" for i in range(N_PROFILED)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i, name in enumerate(names):
            with torch.profiler.record_function(name):
                _, carry = step(frames[i % len(frames)], carry)
        torch.cuda.synchronize()
    trace = pk.chrome_trace(prof)
    rows, _, _ = pk.range_table(trace, names)
    by_name = collections.defaultdict(float)
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel":
            by_name[e["name"]] += e["dur"] / 1e3 / N_PROFILED
    step_ms = [rows[n][2] for n in names if n in rows]
    return dict(step_ms=step_ms, kernels=sum(rows[n][3] for n in names if n in rows) / N_PROFILED,
                by_name=dict(by_name))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m orbslam3_tpu_torch.tools.drives.drive_extract_bench")
    ap.add_argument("n_iters", nargs="?", type=int, default=60)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from ...features.extractor import OrbParams, extract

    dev = device_of(ap, args.device)
    print("device:", device_name(dev), flush=True)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    p = OrbParams(n_features=1200, n_levels=8)
    iters = args.n_iters
    frames = [torch.from_numpy(f).to(dev) for f in make_frames(iters)]
    sync()

    def step(img, carry):
        ff = extract((img.to(torch.float32) + 0.0 * carry).to(torch.uint8), p)
        return ff, ff.response[0]

    t0 = time.time()
    carry = torch.zeros((), device=dev)
    ff, carry = step(frames[0], carry)
    sync()
    print(f"compile+first: {time.time() - t0:.1f}s "
          f"(n_valid {int(ff.valid.sum())})", flush=True)

    t0 = time.time()
    for i in range(iters):
        ff, carry = step(frames[i], carry)
    sync()
    dt = time.time() - t0
    out = dict(device=device_name(dev), iters=iters, ms_per_frame=1e3 * dt / iters,
               fps=iters / dt, device_ms=None)
    print(f"dependent chain: {1e3 * dt / iters:.3f} ms/frame "
          f"({iters / dt:.1f} fps)", flush=True)

    if dev.type != "cuda":
        print("device time: not measured (no CUDA device)", flush=True)
        return out
    prof = device_profile(step, frames, carry)
    ms = sorted(prof["step_ms"])
    total = statistics.median(ms)
    orb = sum(v for k, v in prof["by_name"].items() if "orb_describe" in k)
    out.update(device_ms=total, device_ms_min=ms[0], device_ms_max=ms[-1],
               kernels_per_extract=prof["kernels"], orb_describe_ms=orb,
               orb_describe_share=orb / total,
               top=sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:5])
    print(f"device extract: n={len(ms)} median {total:.3f} ms min {ms[0]:.3f} "
          f"max {ms[-1]:.3f} (kernels, copies and sets; "
          f"{prof['kernels']:.1f} kernels per extract)", flush=True)
    for name, k_ms in out["top"]:
        print(f"  {k_ms:.4f} ms  {100 * k_ms / total:5.1f}%  {name[:90]}", flush=True)
    print(f"orb_describe: {orb * 1e3:.2f} us of device time per extract, "
          f"{100 * orb / total:.2f}% of it", flush=True)
    return out


if __name__ == "__main__":
    main()
