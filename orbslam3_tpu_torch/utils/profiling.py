"""The program's tracer, and the reference's Tracy / REGISTER_TIMES
(SURVEY §5.1/§5.5).

The reference wraps every pipeline stage in Tracy zones (ZoneNamedN,
include/tracy.hpp) and keeps per-stage ms fields (mTime_PreIntIMU etc.,
include/Tracking.h:306-309).  Here:

  * `span(name)` marks a stage of the Systems (`pipeline/system.py`,
    `pipeline/inertial_system.py`, `pipeline/tracking.py`) and `count(name)`
    counts a decision there.  Off by default: `span` returns one shared no-op
    context manager and `count` returns at once; neither reads a clock.
    `enable()` turns the tracer on: each span records its name, the frame
    id of the `frame` span it lies in (each entry point of a System opens
    one with the System's `frame_id`: `System._next_frame`), its parent and its host start and end on
    `time.perf_counter_ns()`; counters are kept per name and per frame;
    everything stays in memory until `spans()` / `counters()` read it.  The
    tracer never synchronizes and never reads the device, so a span's
    duration is the time the host took to enqueue its work.  On a card,
    `enable()` also sets `torch.cuda.set_sync_debug_mode("warn")` and counts
    each warning as one `host_reads` in the innermost open span;
    `disable()` restores the mode and the warning filters it found.
  * `device_anchor()` launches the empty kernel (`ops/orb_patches`) between
    two host-clock reads, and `align(chrome_trace)` finds those launches in a
    profiler trace: the map from `perf_counter_ns` to the trace's clock,
    which places the spans over the device's work (`add_spans`).
  * `StageTimer` keeps per-stage wall times and prints rolling percentiles
    (the REGISTER_TIMES equivalent, and the summary of a run's spans);
    `stage(sync=t)` waits for the device of tensor `t` before it stops the
    clock.
  * `trace()` records a `torch.profiler` Chrome trace (CPU and CUDA
    activities) into a directory (the Tracy-server equivalent), with the
    program's spans on a track of their own where a card anchors them.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
import warnings
from collections import Counter, defaultdict
from typing import NamedTuple

import numpy as np
import torch

# the message of every warning that `set_sync_debug_mode("warn")` raises
SYNC_WARNING = "called a synchronizing CUDA operation"
# the kernel that `device_anchor` launches, as a profiler trace names it
ANCHOR_KERNEL = "orb_empty_kernel"
# `align`: how many anchors may lack their launch in a trace (a profiler can
# lose an activity record), and how far outside its bracket, on the host's
# clock, a launch call may map
MAX_LOST = 2
TOL_NS = 200_000


class Span(NamedTuple):
    name: str
    frame: int | None     # the frame id of the `frame` span it lies in
    parent: int           # index of the enclosing span in `spans()`, -1 for none
    start_ns: int         # host clock, time.perf_counter_ns()
    end_ns: int | None    # None while open
    self_ns: int | None   # duration less the part its child spans cover
    host_reads: int       # sync warnings while it was the innermost open span


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Tracer:
    """The records of one enabled period.  It is its own context manager:
    `open` pushes a span and `__exit__` closes the innermost, which is the
    one a `with` statement opened."""

    def __init__(self):
        self._rec: list = []        # [name, frame, parent, start, end, host_reads]
        self._open: list = []       # indices of the open spans, innermost last
        self._counts: dict = defaultdict(Counter)   # name -> frame -> n
        self._restore = None

    def open(self, name: str, frame: int | None):
        parent = self._open[-1] if self._open else -1
        if frame is None and parent >= 0:
            frame = self._rec[parent][1]
        self._open.append(len(self._rec))
        self._rec.append([name, frame, parent, time.perf_counter_ns(), None, 0])
        return self

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        self._rec[self._open.pop()][4] = time.perf_counter_ns()
        return False

    def add(self, name: str, n: int) -> None:
        self._counts[name][self._rec[self._open[-1]][1] if self._open else None] += n

    def host_read(self) -> None:
        if self._open:
            self._rec[self._open[-1]][5] += 1
        self.add("host_reads", 1)

    def spans(self) -> list[Span]:
        child_ns = Counter()
        for name, frame, parent, t0, t1, reads in self._rec:
            if parent >= 0 and t1 is not None:
                child_ns[parent] += t1 - t0
        return [Span(name, frame, parent, t0, t1, None if t1 is None else t1 - t0 - child_ns[i],
                     reads)
                for i, (name, frame, parent, t0, t1, reads) in enumerate(self._rec)]

    def counters(self) -> dict:
        return {name: dict(per) for name, per in self._counts.items()}

    def clear(self) -> None:
        self._rec.clear()
        self._open.clear()
        self._counts.clear()


_TRACER: Tracer | None = None


def span(name: str, frame: int | None = None):
    """A context manager around one stage; `frame` names the frame of a
    root span (`System.track_monocular`'s), the others take their parent's."""
    tracer = _TRACER
    if tracer is None:
        return _NO_SPAN
    return tracer.open(name, frame)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the frame whose span is open."""
    tracer = _TRACER
    if tracer is None:
        return
    tracer.add(name, n)


def enable() -> Tracer:
    """Turn the tracer on (a no-op if it is on); returns it."""
    global _TRACER
    if _TRACER is not None:
        return _TRACER
    tracer = Tracer()
    filters = warnings.catch_warnings()
    filters.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            tracer.host_read()
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    tracer._restore = (filters, mode)
    _TRACER = tracer
    return tracer


def disable() -> None:
    """Turn the tracer off and restore the sync debug mode and the warning
    filters that `enable` found; what it recorded is dropped."""
    global _TRACER
    tracer, _TRACER = _TRACER, None
    if tracer is None:
        return
    filters, mode = tracer._restore
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    filters.__exit__(None, None, None)


def reset() -> None:
    """Drop what the enabled tracer recorded so far."""
    if _TRACER is not None:
        _TRACER.clear()


def spans() -> list[Span]:
    """Every span recorded since `enable` / `reset`, in the order they opened."""
    return [] if _TRACER is None else _TRACER.spans()


def counters() -> dict:
    """{counter: {frame id: n}} since `enable` / `reset` (frame None: outside
    any frame)."""
    return {} if _TRACER is None else _TRACER.counters()


# ------------------------------------------------------ the device's clock
def device_anchor(device=None) -> tuple[int, int]:
    """Launch the empty kernel on the current stream of `device` (default
    the current card) between two `perf_counter_ns()` reads; returns the
    bracket."""
    from ..ops import orb_patches

    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    t0 = time.perf_counter_ns()
    orb_patches.empty_kernel(dev)
    t1 = time.perf_counter_ns()
    return t0, t1


class Alignment(NamedTuple):
    """trace_us = origin_us + (ns - origin_ns) * us_per_ns: the host clock
    (`perf_counter_ns`) on a profiler trace's clock (µs).  `kept`: the
    indices of the anchors whose launches the trace holds; `widths_ns`:
    their brackets; `errors_ns`: the bound on the map's error at each (half
    its bracket less its launch call's own duration)."""
    origin_ns: float
    origin_us: float
    us_per_ns: float
    kept: list
    widths_ns: list
    errors_ns: list

    def to_trace_us(self, ns: float) -> float:
        return self.origin_us + (ns - self.origin_ns) * self.us_per_ns

    def to_host_ns(self, us: float) -> float:
        return self.origin_ns + (us - self.origin_us) / self.us_per_ns


def anchor_launches(chrome_trace: dict) -> tuple[list, set]:
    """The trace's anchor launches: their runtime calls' (start, duration)
    in µs, in order, and their correlation ids."""
    ev = chrome_trace["traceEvents"]
    corr = {e["args"]["correlation"] for e in ev
            if e.get("cat") == "kernel" and ANCHOR_KERNEL in e.get("name", "")}
    calls = sorted((e["ts"], e.get("dur", 0.0)) for e in ev
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("args", {}).get("correlation") in corr)
    return calls, corr


def _fit(anchors: list, calls: list, kept: list) -> Alignment:
    room = [max(0.0, (t1 - t0) - 1e3 * dur) for (t0, t1), (_, dur) in zip(anchors, calls)]
    host = [t0 + r / 2 for (t0, _), r in zip(anchors, room)]
    ts = [c[0] for c in calls]
    rate = (ts[-1] - ts[0]) / (host[-1] - host[0]) if len(ts) > 1 else 1e-3
    return Alignment(host[0], ts[0], rate, kept, [t1 - t0 for t0, t1 in anchors],
                     [r / 2 for r in room])


def align(chrome_trace: dict, anchors: list) -> Alignment:
    """The map from `perf_counter_ns` to `chrome_trace`'s µs from the
    anchors' launches in it and `anchors` (brackets of `device_anchor`, in
    the order they were made).  A launch call starts, on the
    host, where its bracket less the call's own duration leaves as much
    room before it as after (the first launch under a profiler can take
    milliseconds); the offset comes from the first anchor, the rate from
    the last.  A profiler can lose an activity record: up to `MAX_LOST`
    anchors may lack their launch.  The pairing kept puts every call inside
    its bracket, within `TOL_NS`, and of those the one whose clocks drift
    apart least over the slice (both clocks count nanoseconds); a tie keeps
    the earlier anchors, since a profiler loses the records made just before
    it stops."""
    calls, _ = anchor_launches(chrome_trace)
    n, m = len(anchors), len(calls)
    if not calls or m > n or n - m > MAX_LOST:
        raise ValueError(f"{m} anchor launches in the trace for {n} anchors")
    best = None
    for lost in reversed(list(itertools.combinations(range(n), n - m))):
        kept = [j for j in range(n) if j not in lost]
        al = _fit([anchors[j] for j in kept], calls, kept)
        worst = 0.0
        for j, (ts, dur) in zip(kept, calls):
            h = al.to_host_ns(ts)
            t0, t1 = anchors[j]
            worst = max(worst, t0 - h, h - max(t0, t1 - 1e3 * dur))
        drift = abs(al.us_per_ns * 1e3 - 1.0) * (al.to_host_ns(calls[-1][0]) - al.origin_ns)
        if worst <= TOL_NS and (best is None or worst + drift < best[0]):
            best = (worst + drift, al)
    if best is None:
        raise ValueError(f"no pairing of {m} anchor launches with {n} anchors fits within "
                         f"{TOL_NS} ns")
    return best[1]


def add_spans(chrome_trace: dict, alignment: Alignment, recorded: list[Span]) -> None:
    """Write the closed spans into `chrome_trace` as complete events of a
    process of their own ("program spans"), on the trace's clock."""
    ev = chrome_trace["traceEvents"]
    pid = 1 + max((e["pid"] for e in ev if isinstance(e.get("pid"), int)), default=0)
    ev.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "program spans"}})
    for s in recorded:
        if s.end_ns is None:
            continue
        ev.append({"name": s.name, "cat": "program_span", "ph": "X", "pid": pid, "tid": 0,
                   "ts": alignment.to_trace_us(s.start_ns),
                   "dur": (s.end_ns - s.start_ns) * alignment.us_per_ns,
                   "args": {"frame": s.frame, "host_reads": s.host_reads}})


# ------------------------------------------------------------------ summaries
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

    @classmethod
    def from_spans(cls, recorded: list[Span]) -> "StageTimer":
        """The host durations of closed spans, by name."""
        timer = cls()
        for s in recorded:
            if s.end_ns is not None:
                timer.record(s.name, (s.end_ns - s.start_ns) / 1e9)
        return timer

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        with span(name):
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
    where a card is present) with the tracer on, and write it to
    `logdir/trace.json`, viewable in Perfetto or chrome://tracing.  On a
    card, anchors at both ends place the program's spans in the trace; the
    spans' summary is printed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    owned = _TRACER is None
    tracer = enable()
    first, anchors = len(tracer._rec), []
    try:
        with torch.profiler.profile(activities=acts) as prof:
            if cuda:
                # a profile's first launch spends milliseconds in the driver:
                # one before the first anchor keeps its bracket tight
                torch.ones(1, device="cuda")
                anchors.append(device_anchor())
            yield prof
            if cuda:
                anchors.append(device_anchor())
                torch.cuda.synchronize()
        recorded = tracer.spans()[first:]
        os.makedirs(logdir, exist_ok=True)
        path_ = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path_)
        if cuda:
            with open(path_) as f:
                out = json.load(f)
            al = align(out, anchors)
            add_spans(out, al, recorded)
            with open(path_, "w") as f:
                json.dump(out, f)
            print(f"spans placed on the trace's clock within {max(al.errors_ns) / 1e3:.1f} us",
                  flush=True)
    finally:
        if owned:
            disable()
    print(f"profile written to {path_}", flush=True)
    if recorded:
        print(StageTimer.from_spans(recorded).summary(), flush=True)
