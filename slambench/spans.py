"""The program's own spans and counters, for the readers that need them.

`run.py` hands a reader the window's frames, the outside ranges and the
profiled slice's summary; it knows nothing of the program's tracer
(`orbslam3_tpu_torch.utils.profiling`), and no file that the benchmark
already has is edited to tell it.  A reader that reads the tracer calls
`install()` when it is loaded, which `run.py` does with `--trace 1` only,
before it builds the System:

* the tracer is turned on, so the set-up's spans exist (on a card it also
  counts the host's blocking reads, `host_reads`);
* on a card, a profiler run of CUDA activity alone (the slice's) launches
  `profiling.device_anchor()` once it has started and twice before it
  stops, outside the frames that `run.py` times: they map the host clock
  onto the trace's (`profiling.align`; the profiler can lose the record of
  the last launch before it stops, and the one before stands in);
* `trace.device_summary` also gives `spans` (`attribute`): each kernel's
  owner, the innermost span open when its launching runtime call ran (the
  rule of `trace.range_table`), and each idle gap's, the innermost span open
  on the host across it.  The anchors' kernels and runtime calls are taken
  out of the trace that the summary reads, so the accepted metrics count
  the program's work alone over the same wall time.

`window(ctx)` gives the readers the spans and counters with the window's
frame ids and prints, once a run, the slice's `idle_by_span` and the
window's notes on stderr (`report`).  With a program that has no tracer
every reader reads None and nothing is hooked.
"""

from __future__ import annotations

import bisect
import collections
import json
import statistics
import sys
from typing import NamedTuple

OUTSIDE = "outside frames"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _State:
    installed = False
    profiling = None     # the program's tracer module, once turned on
    undo: list = []
    anchors: list = []   # brackets of the anchors not yet read by a summary
    cache = None         # (id(ctx), Window)
    reported = False


def install() -> bool:
    """Turn the program's tracer on and hook the harness (see the module's
    note); False, with nothing changed, when the program has no tracer."""
    if _State.installed:
        return _State.profiling is not None
    _State.installed = True
    try:
        from orbslam3_tpu_torch.utils import profiling
    except ImportError:
        return False
    if not hasattr(profiling, "enable"):
        return False
    import torch

    from . import trace

    profiling.enable()
    _State.profiling = profiling
    _replace(trace, "device_summary", _summary(trace.device_summary))
    if torch.cuda.is_available():
        _replace(torch.profiler, "profile", _anchored(torch.profiler.profile))
    return True


def uninstall() -> None:
    """Undo `install` (tests)."""
    for mod, attr, fn in reversed(_State.undo):
        setattr(mod, attr, fn)
    if _State.profiling is not None:
        _State.profiling.disable()
    _State.installed, _State.profiling, _State.undo = False, None, []
    _State.anchors, _State.cache, _State.reported = [], None, False


def _replace(mod, attr, fn):
    _State.undo.append((mod, attr, getattr(mod, attr)))
    setattr(mod, attr, fn)


def _anchored(profile):
    """`profile` (torch.profiler's) whose runs of CUDA activity alone launch
    an anchor after they start and two before they stop (then wait for
    them), and keep the three brackets in `_State.anchors`."""
    import torch
    cuda_only = {torch.profiler.ProfilerActivity.CUDA}

    class Anchored(profile):
        def __enter__(self):
            out = super().__enter__()
            if self.activities == cuda_only:
                _State.anchors = [_State.profiling.device_anchor()]
            return out

        def __exit__(self, *exc):
            if self.activities == cuda_only:
                _State.anchors += [_State.profiling.device_anchor() for _ in range(2)]
                torch.cuda.synchronize()
            return super().__exit__(*exc)

    return Anchored


def _summary(device_summary):
    def run(chrome_trace):
        anchors, _State.anchors = _State.anchors, []
        _, corr = _State.profiling.anchor_launches(chrome_trace)
        kept = [e for e in chrome_trace["traceEvents"]
                if e.get("args", {}).get("correlation") not in corr]
        out = device_summary(dict(chrome_trace, traceEvents=kept))
        out["spans"] = None
        if anchors:
            try:
                out["spans"] = attribute(chrome_trace, anchors, _State.profiling.spans())
            except ValueError as e:
                print(f"slambench.spans: the slice is not attributed: {e}", file=sys.stderr)
        return out
    return run


# --------------------------------------------------------------- attribution
def innermost(recorded: list, starts: list, t0: float, t1: float | None = None) -> int:
    """The innermost span open on the host across [t0, t1] (t1 None: at
    t0), -1 if none; `starts` are the spans' start times in their order."""
    t1 = t0 if t1 is None else t1
    i = bisect.bisect_right(starts, t0) - 1
    while i >= 0 and (recorded[i].end_ns is None or recorded[i].end_ns < t1):
        i = recorded[i].parent
    return i


def path(recorded: list, i: int) -> str:
    """'frame/track/track_local_map/pose_opt', or `OUTSIDE` for a span not
    inside a `frame` span (and for i = -1)."""
    names = []
    while i >= 0:
        names.append(recorded[i].name)
        i = recorded[i].parent
    return "/".join(reversed(names)) if names and names[-1] == "frame" else OUTSIDE


def attribute(chrome_trace: dict, anchors: list, recorded: list) -> dict:
    """The profiled slice by span: kernel launches by the path of their
    owner, the frames in the slice, the frames in which each span name ran,
    and the device's idle seconds by the path of the span open across each
    gap (between the first anchor's kernel and the last's)."""
    prof = _State.profiling
    al = prof.align(chrome_trace, anchors)
    ev = chrome_trace["traceEvents"]
    _, anchor_corr = prof.anchor_launches(chrome_trace)
    device = [e for e in ev if e.get("cat") in DEVICE_CATS]
    anchor_ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in device
                        if e["args"].get("correlation") in anchor_corr)
    starts = [s.start_ns for s in recorded]
    lo, hi = anchors[0][0], anchors[-1][1]
    frames = sorted(s.frame for s in recorded
                    if s.name == "frame" and s.start_ns >= lo and s.end_ns is not None
                    and s.end_ns <= hi)
    in_slice = set(frames)
    ran = collections.defaultdict(set)
    for s in recorded:
        if s.frame in in_slice:
            ran[s.name].add(s.frame)

    launched = {}
    for e in ev:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launched.setdefault(e.get("args", {}).get("correlation"), e["ts"])
    owned = collections.Counter()
    n = 0
    work = []
    for e in device:
        c = e["args"].get("correlation")
        if c in anchor_corr:
            continue
        work.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "kernel":
            n += 1
            ts = launched.get(c)
            owned[OUTSIDE if ts is None else
                  path(recorded, innermost(recorded, starts, al.to_host_ns(ts)))] += 1
    work.sort()
    idle = collections.Counter()

    def gap(t0, t1):
        i = innermost(recorded, starts, al.to_host_ns(t0), al.to_host_ns(t1))
        idle[path(recorded, i)] += (t1 - t0) / 1e6

    if anchor_ops:
        end, stop = anchor_ops[0][1], anchor_ops[-1][0]
        for t0, t1 in work:
            if min(t0, stop) > end:
                gap(end, min(t0, stop))
            end = max(end, t1)
            if end >= stop:
                break
        if stop > end:
            gap(end, stop)
    return dict(launches=n, owned=dict(owned), frames=frames,
                ran={k: sorted(v) for k, v in ran.items()}, idle=dict(idle),
                widths_ns=al.widths_ns, errors_ns=al.errors_ns,
                lost=sorted(set(range(len(anchors))) - set(al.kept)))


def launches_per_frame(ctx, name: str, frames_that_ran_one: bool) -> float | None:
    """Kernel launches owned by spans named `name` (and their children) in
    the profiled slice, over its frames (those that ran one)."""
    a = ctx.get("slice", {}).get("spans")
    if not a or not a["frames"]:
        return None
    frames = a["ran"].get(name, []) if frames_that_ran_one else a["frames"]
    if not frames:
        return None
    n = sum(v for p, v in a["owned"].items() if name in p.split("/"))
    return n / len(frames)


# -------------------------------------------------------------------- window
class Window(NamedTuple):
    spans: list       # every span of the run (`profiling.Span`)
    counters: dict    # {counter: {frame id: n}}
    frames: set       # the window's frame ids (the System's frame_id)
    first: int        # the window's first frame id: before it, set-up


def window(ctx) -> Window | None:
    """The tracer's records with the window's frames, None without a
    tracer; reports once on stderr."""
    if _State.profiling is None or not ctx.get("frames"):
        return None
    if _State.cache is None or _State.cache[0] != id(ctx):
        frames = {f.index for f in ctx["frames"]}
        w = Window(_State.profiling.spans(), _State.profiling.counters(), frames, min(frames))
        _State.cache = (id(ctx), w)
        if not _State.reported:
            _State.reported = True
            print("slambench.spans: " + json.dumps(report(ctx, w)), file=sys.stderr)
    return _State.cache[1]


def report(ctx, w: Window) -> dict:
    """`idle_by_span` (the ten span paths that hold the most device-idle
    seconds in the slice), the slice's launches inside frames, and the
    window's keyframe reasons, VI branches, retries and losses, the five
    spans with the most host reads, the span paths' self ms a frame."""
    def total(prefix):
        return {k: sum(n for f, n in per.items() if f in w.frames)
                for k, per in w.counters.items() if k.startswith(prefix)}
    reads = collections.Counter()
    self_ms = collections.Counter()
    for i, s in enumerate(w.spans):
        if s.frame in w.frames and s.end_ns is not None:
            p = path(w.spans, i)
            reads[p] += s.host_reads
            self_ms[p] += s.self_ns / 1e6 / len(w.frames)
    out = dict(kf_reasons=total("kf."), vi_branches=total("vi."), track_retries=total("track."),
               host_reads_top=[[p, n] for p, n in reads.most_common(5) if n],
               self_ms_per_frame=[[p, round(v, 3)] for p, v in self_ms.most_common(12)])
    a = ctx.get("slice", {}).get("spans")
    if a:
        idle = sum(a["idle"].values())
        out.update(idle_by_span=[[p, s] for p, s in collections.Counter(a["idle"]).most_common(10)],
                   idle_s=idle, launches=a["launches"],
                   launches_inside_frames=a["launches"] - a["owned"].get(OUTSIDE, 0),
                   anchor_widths_us=[w_ / 1e3 for w_ in a["widths_ns"]],
                   anchor_errors_us=[e / 1e3 for e in a["errors_ns"]], anchors_lost=a["lost"],
                   slice_frames=len(a["frames"]))
    return out


def median_ms(w: Window, name: str) -> float | None:
    """Host median, in ms, of the spans named `name` in the window's frames."""
    v = [(s.end_ns - s.start_ns) / 1e6 for s in w.spans
         if s.name == name and s.frame in w.frames and s.end_ns is not None]
    return statistics.median(v) if v else None
