"""Profiling and observability (the reference's Tracy / REGISTER_TIMES,
SURVEY §5.1/§5.5).

The port of `orbslam3_tpu/utils/profiling.py`.  The reference wraps every
pipeline stage in Tracy zones (ZoneNamedN, include/tracy.hpp) and keeps
per-stage ms fields (mTime_PreIntIMU etc., include/Tracking.h:306-309).
Here:

  * `StageTimer` collects per-stage wall times and prints rolling
    percentiles (the REGISTER_TIMES equivalent); `stage(sync=t)` waits for
    the device of tensor `t` before it stops the clock;
  * `trace()` records a `torch.profiler` Chrome trace (CPU and CUDA
    activities) into a directory (the Tracy-server equivalent);
  * `Verbose` mirrors the reference's leveled stdout logger
    (include/Verbose.h:10-35).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch


class Verbose:
    """Leveled logger (reference Verbose::PrintMess)."""
    QUIET, NORMAL, VERBOSE, VERY_VERBOSE, DEBUG = range(5)
    level = NORMAL

    @classmethod
    def print(cls, msg: str, level: int = 1):
        if level <= cls.level:
            print(msg, flush=True)


def _wait_for(sync) -> None:
    """Wait until the work that produced every tensor in `sync` (a tensor or
    a nested tuple / list / dict of them) is done on its device."""
    if isinstance(sync, torch.Tensor):
        if sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
    elif isinstance(sync, dict):
        for v in sync.values():
            _wait_for(v)
    elif isinstance(sync, (tuple, list)):
        for v in sync:
            _wait_for(v)


class StageTimer:
    """Per-stage timing accumulator with device synchronization."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _wait_for(sync)
        self.times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.times[name].append(seconds)

    def summary(self) -> str:
        lines = []
        for name, ts in sorted(self.times.items()):
            a = np.asarray(ts) * 1e3
            lines.append(
                f"{name:28s} n={len(a):5d} median={np.median(a):8.2f}ms "
                f"p90={np.percentile(a, 90):8.2f}ms mean={a.mean():8.2f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "profile_out"):
    """Record a torch.profiler trace of the enclosed work (CPU, and CUDA
    where a card is present) and write it to `logdir/trace.json`, viewable
    in Perfetto or chrome://tracing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}", flush=True)
