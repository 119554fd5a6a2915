"""Ranges around the program's stages, and what a profiler trace says.

The ranges are put in from outside the program: a module attribute is
replaced by a wrapper that times the call on the host clock and marks it as
a `torch.profiler` range, so every caller that looks the attribute up at
call time runs through it.  A caller that bound the function by name
(`from x import f`) does not.  `range_table` and the Chrome-trace reading
are frozen copies of the port's keyframe profiler's (a range owns the device
work whose launching runtime call lies inside it on the host).
"""

from __future__ import annotations

import bisect
import collections
import functools
import importlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Ranges:
    """Per wrapped attribute, (frame, host seconds) of every call while
    `on`; `frame` is set by the caller before each frame."""

    def __init__(self):
        self.times = collections.defaultdict(list)
        self.on = False
        self.frame = -1
        self._undo = []

    def wrap(self, module: str, attr: str, name: str):
        import torch
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        times = self.times[name]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            times.append((self.frame, time.perf_counter() - t0))
            return out

        self.replace(mod, attr, wrapper)

    def replace(self, mod, attr: str, fn):
        """Set a module attribute until `restore`."""
        self._undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    def restore(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()


def chrome_trace(prof) -> dict:
    """The Chrome trace of a finished torch.profiler run, as a dict (written
    to the run's TMPDIR and removed)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def range_table(trace: dict, names) -> tuple[dict, float, int]:
    """Per range name, [calls, host ms, device ms, kernel launches], where a
    range owns the device work (kernels, copies, sets) whose launching
    runtime call lies inside it on the host; also the device's busy ms and
    kernel count over the whole trace."""
    ev = trace["traceEvents"]
    dev = {e["args"]["correlation"]: e for e in ev if e.get("cat") in DEVICE_CATS}
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


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces of ATen and its
    argument list: the template arguments (the functor) stay.  Copies and
    sets keep their names."""
    if not name.startswith("void "):
        return name
    name = name[5:].replace("at::native::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def device_summary(trace: dict) -> dict:
    """From a trace of CUDA activity: the seconds in which any kernel, copy
    or set ran (their union), the kernel launches, the total seconds by
    operation name, each `orb_describe` launch's seconds, and the idle gaps
    between device work (seconds, the name of the operation that ended
    each)."""
    work = sorted((e["ts"], e["ts"] + e["dur"], short_name(e["name"]), e["cat"])
                  for e in trace["traceEvents"] if e.get("cat") in DEVICE_CATS)
    busy = 0.0
    gaps = []
    end = None
    by_name = collections.Counter()
    describe = []
    for t0, t1, name, cat in work:
        by_name[name] += (t1 - t0) / 1e6
        if cat == "kernel" and "orb_describe" in name and "warp" not in name:
            describe.append((t1 - t0) / 1e6)
        if end is None or t0 >= end:
            if end is not None:
                gaps.append(((t0 - end) / 1e6, name))
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return dict(busy_s=busy / 1e6, launches=sum(w[3] == "kernel" for w in work),
                by_name=by_name, orb_describe_s=describe, gaps=gaps)
