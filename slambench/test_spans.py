"""The readers of the program's spans and counters (`spans.py`), on the CPU.

    python -m pytest slambench -q

They hold the attribution of a slice's launches and idle gaps to spans on a
synthetic trace, each new reader on a synthetic `ctx`, the readers' None
where the program has no tracer, and the flight cell at a small size traced
end to end.
"""

from __future__ import annotations

import time
import warnings

import pytest
import torch

from orbslam3_tpu_torch.utils import profiling
from slambench import run, spans, trace
from slambench.test_slambench import small

MS = 1_000_000          # ns
OFFSET_US = 50.0        # the synthetic trace's clock: host ns / 1000 + 50


def _us(ns):
    return ns / 1000 + OFFSET_US


def _span(name, frame, parent, t0_ms, t1_ms):
    return profiling.Span(name, frame, parent, int(t0_ms * MS), int(t1_ms * MS), 0, 0)


# frame 0: track [3, 9] ms with pose_opt [4, 6]; frame 1: track [12, 17]
RECORDED = [_span("frame", 0, -1, 2, 10), _span("track", 0, 0, 3, 9),
            _span("pose_opt", 0, 1, 4, 6), _span("frame", 1, -1, 11, 18),
            _span("track", 1, 3, 12, 17)]
ANCHORS = [(1 * MS - 500, 1 * MS + 500), (19 * MS - 500, 19 * MS + 500)]


def _trace():
    """Anchor launches at the anchors' midpoints (their kernels run 5 us
    later for 1 us), and four kernels: launched in pose_opt, in frame 0's
    track, between the frames and in frame 1's track."""
    ev = []

    def launch(corr, host_ms, run_ms, dur_us, name):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": _us(host_ms * MS),
                   "dur": 2.0, "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": name, "ts": _us(run_ms * MS), "dur": dur_us,
                   "args": {"correlation": corr}})
    launch(1, 1, 1.005, 1.0, "orb_empty_kernel()")
    launch(2, 4.5, 4.6, 400.0, "gemm")               # runs 4.6-5.0 ms
    launch(3, 7.0, 8.0, 100.0, "add")                # 8.0-8.1: gap 5.0-8.0 in track
    launch(4, 10.5, 10.6, 100.0, "copy")             # 10.6-10.7: gap 8.1-10.6 outside
    launch(5, 13.0, 13.2, 1000.0, "mul")             # 13.2-14.2: gap 10.7-13.2 outside
    launch(6, 19, 19.005, 1.0, "orb_empty_kernel()")  # gap 14.2-19.005 outside
    ev.append({"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": _us(4.55 * MS), "dur": 10.0,
               "args": {"correlation": 9}})
    return {"traceEvents": ev}


@pytest.fixture
def installed():
    assert spans.install()
    yield
    spans.uninstall()


def test_attribute_owns_launches_and_idle_by_span(installed):
    a = spans.attribute(_trace(), ANCHORS, RECORDED)
    assert a["launches"] == 4 and a["frames"] == [0, 1]
    assert a["owned"] == {"frame/track/pose_opt": 1, "frame/track": 2, spans.OUTSIDE: 1}
    assert a["ran"] == {"frame": [0, 1], "track": [0, 1], "pose_opt": [0]}
    idle = {k: round(v * 1e3, 6) for k, v in a["idle"].items()}
    # 4.56-4.6 ms in pose_opt, 5.0-8.0 in track; 1.006-4.55 starts before
    # frame 0 and the rest cross a frame's end
    assert idle == {"frame/track/pose_opt": 0.04, "frame/track": 3.0,
                    spans.OUTSIDE: round(3.544 + 2.5 + 2.5 + 4.805, 6)}
    assert a["widths_ns"] == [1000, 1000] and a["lost"] == []
    ctx = {"slice": {"spans": a}}
    assert spans.launches_per_frame(ctx, "pose_opt", True) == 1.0
    assert spans.launches_per_frame(ctx, "track", False) == 1.5
    assert spans.launches_per_frame(ctx, "preintegrate", False) == 0.0
    assert spans.launches_per_frame(ctx, "preintegrate", True) is None
    assert spans.launches_per_frame({"slice": {"spans": None}}, "track", False) is None


def test_attribute_survives_the_last_anchor_lost(installed):
    """The slice ends with two anchors; a trace that lost the last one's
    records is attributed as the whole one is."""
    whole = spans.attribute(_trace(), ANCHORS, RECORDED)
    three = ANCHORS + [(19 * MS + 19_500, 19 * MS + 20_500)]
    a = spans.attribute(_trace(), three, RECORDED)
    assert a["lost"] == [2] and a["owned"] == whole["owned"] and a["idle"] == whole["idle"]


def test_the_summary_reads_the_trace_without_the_anchors(installed):
    spans._State.anchors = list(ANCHORS)
    out = trace.device_summary(_trace())
    assert out["launches"] == 4 and len(out["orb_describe_s"]) == 0
    assert out["busy_s"] == pytest.approx((400 + 10 + 100 + 100 + 1000) / 1e6)
    assert out["spans"]["launches"] == 4 and spans._State.anchors == []


def test_the_slice_profile_anchors_outside_its_body(installed, monkeypatch):
    """A profiler run of CUDA activity alone launches one anchor after it
    starts and two before it stops; a run with CPU activity launches none."""
    CUDA, CPU = torch.profiler.ProfilerActivity.CUDA, torch.profiler.ProfilerActivity.CPU
    events = []

    class Profile:
        def __init__(self, activities):
            self.activities = set(activities)

        def __enter__(self):
            events.append("start")
            return self

        def __exit__(self, *exc):
            events.append("stop")
            return False

    def anchor():
        events.append("anchor")
        return (len(events), len(events) + 1)
    monkeypatch.setattr(spans._State.profiling, "device_anchor", anchor)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: events.append("sync"))
    Anchored = spans._anchored(Profile)
    with Anchored(activities=[CUDA]):
        events.append("body")
    assert events == ["start", "anchor", "body", "anchor", "anchor", "sync", "stop"]
    assert spans._State.anchors == [(2, 3), (4, 5), (5, 6)]
    events.clear()
    with Anchored(activities=[CPU, CUDA]):
        events.append("body")
    assert events == ["start", "body", "stop"] and spans._State.anchors == [(2, 3), (4, 5), (5, 6)]


def _fake_run():
    """Spans, counters and host reads of frames 0-7 through the tracer;
    the window is frames 5-7."""
    for f in range(8):
        with profiling.span("frame", f):
            with profiling.span("extract"):
                time.sleep(0.0005 * (1 + f % 3))
            if f in (2, 6):
                with profiling.span("imu_init"):
                    time.sleep(0.001)
            if f >= 4:
                profiling.count("kf.max_frames" if f % 2 else "kf.both")
                with profiling.span("host_read"):
                    warnings.warn(profiling.SYNC_WARNING)
                warnings.warn(profiling.SYNC_WARNING)


def test_new_readers_on_a_synthetic_ctx(installed, capsys):
    readers = {n: run.load_metric(n) for n in (
        "extract.host_ms", "host_reads_per_frame", "imu_init.host_s",
        "pose_opt.launches_per_frame", "vi_pose_opt.launches_per_frame",
        "preintegrate.launches_per_frame")}
    _fake_run()
    rec = profiling.spans()
    ctx = dict(frames=[run.Frame(i, 0.1, True, False, False) for i in (5, 6, 7)],
               slice=dict(spans=spans.attribute(_trace(), ANCHORS, RECORDED)))
    got = {n: r.read(ctx) for n, r in readers.items()}
    ext = sorted((s.end_ns - s.start_ns) / 1e6 for s in rec
                 if s.name == "extract" and s.frame >= 5)
    assert got["extract.host_ms"] == pytest.approx(ext[1])
    assert got["host_reads_per_frame"] == 2.0
    init = [(s.end_ns - s.start_ns) / 1e9 for s in rec if s.name == "imu_init"]
    assert got["imu_init.host_s"] == pytest.approx(init[0])      # frame 2 only: set-up
    assert got["pose_opt.launches_per_frame"] == 1.0
    assert got["vi_pose_opt.launches_per_frame"] is None
    assert got["preintegrate.launches_per_frame"] == 0.0
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("slambench.spans")]
    assert len(line) == 1
    for key in ('"kf_reasons": {"kf.both": 1, "kf.max_frames": 2}', '"idle_by_span": [[',
                '"host_reads_top": [["frame", 3], ["frame/host_read", 3]]'):
        assert key in line[0], line[0]


def test_readers_read_none_without_the_tracer(monkeypatch):
    monkeypatch.delattr(profiling, "enable")
    try:
        assert not spans.install()
        ctx = dict(frames=[run.Frame(5, 0.1, True, False, False)], slice={})
        for name in ("extract.host_ms", "host_reads_per_frame", "imu_init.host_s",
                     "pose_opt.launches_per_frame"):
            assert run.load_metric(name).read(ctx) is None
        assert not spans._State.undo
    finally:
        spans.uninstall()
    assert profiling._TRACER is None


def test_the_flight_cell_traced_at_a_small_size_on_the_cpu(monkeypatch):
    """`--trace 1` on the CPU (`torch.cuda.synchronize` a no-op there, the
    profiler's activity the CPU's): the span readers read, the device ones
    read None and are left out."""
    profile = torch.profiler.profile
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: profile(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    spec, ov = small(run.load_cell("euroc_mono.flight"))
    try:
        out = run.run_cell(spec, 2 ** 31 + 777, 3.0, True, device="cpu", overrides=ov)
    finally:
        spans.uninstall()
    m = out["metrics"]
    assert m["extract.host_ms"]["value"] > 0 and m["extract.host_ms"]["unit"] == "ms"
    assert m["host_reads_per_frame"]["value"] == 0.0
    assert "pose_opt.launches_per_frame" not in m
    assert "tracked_frame_ms.p50" in m and out["failed"] == 0
