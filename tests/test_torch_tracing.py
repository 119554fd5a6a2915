"""The port's tracer (`orbslam3_tpu_torch/utils/profiling.py`) and the spans
and counters in the Systems, on the CPU: a small monocular drive
(`seeded_scene`'s plane at 240x376, as `test_torch_system.py`'s small drive)
and a small mono-inertial drive (`imu_scene`'s flight at 240x376, with a
keyframe every 3 frames so that the IMU init and VIBA1 fall within 25
frames), each with the tracer off (the host clock made to raise) and on.
Also the clock map on a synthetic Chrome trace and the sync-warning hook.

Marked `gpu` (run on the card with `--noconftest`; this file imports no
JAX): the anchors' clock map against a known host sleep, and the tracer's
`host_reads` against `utils/sync_census`'s count on the same drive.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time
import warnings

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.features.extractor import OrbParams
from orbslam3_tpu_torch.pipeline import inertial_system, system
from orbslam3_tpu_torch.utils import imu_scene, profiling
from orbslam3_tpu_torch.utils import seeded_scene as ss

MONO = ss.SceneConfig(hw=(240, 376), K4=(400.0, 400.0, 188.0, 120.0),
                      orb=OrbParams(n_features=500, n_levels=4), seed_frames=(),
                      track_frames=tuple(range(45)), view_points=2048,
                      ba_caps=(8, 1024, 4096), new_pt_budget=256)
INERTIAL = imu_scene.InertialScene(hw=(240, 376), K4=(200.0, 200.0, 188.0, 120.0),
                                   orb=OrbParams(n_features=500, n_levels=4), frames=25,
                                   tex_scale=30.0)


def _mono_drive(frames, device="cpu"):
    """(System, per frame (n_kf before, n_kf after, IMU stage frame))."""
    sys_ = system.System(ss.system_config(MONO), device=device)
    log = []
    for fi in MONO.track_frames:
        n_kf = sys_.n_kf_host
        sys_.track_monocular(frames[fi], fi / 10.0)
        log.append((n_kf, sys_.n_kf_host, -1))
    return sys_, log


def _inertial_drive(frames, device="cpu"):
    scfg = dataclasses.replace(imu_scene.slam_config(INERTIAL), max_frames_between_kf=3,
                               ba_caps=(8, 1024, 4096), new_pt_budget=256,
                               local_view_points=2048)
    icfg = inertial_system.InertialConfig(imu_freq=imu_scene.IMU_HZ, init_time_s=1.0,
                                          init_min_kfs=4, refine_time_s=1.5,
                                          refine2_time_s=1e9, fiba_cams=16, fiba_iters=4)
    sys_ = inertial_system.InertialSystem(scfg, icfg, device=device)
    log = []
    for i in range(INERTIAL.frames):
        n_kf = sys_.n_kf_host
        for s in imu_scene.imu_samples(i):
            sys_.grab_imu(*s)
        sys_.track_monocular(frames[i], ts=i / imu_scene.FPS)
        log.append((n_kf, sys_.n_kf_host, sys_.last_imu_stage_frame))
    return sys_, log


def _state(sys_):
    """What the drive produced: the trajectory and every map tensor."""
    traj = np.stack([np.concatenate([R.ravel(), t]) for _, R, t in sys_.trajectory])
    return traj, {k: v.clone() for k, v in sys_.map._asdict().items()}


def _both(drive, frames):
    """The drive with the tracer off (the host's ns clock raising) and on."""
    def no_clock():
        raise AssertionError("the tracer read the clock while off")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "perf_counter_ns", no_clock)
        off_sys, off_log = drive(frames)
    profiling.enable()
    try:
        on_sys, on_log = drive(frames)
        recorded, counted = profiling.spans(), profiling.counters()
    finally:
        profiling.disable()
    return dict(off=_state(off_sys), off_log=off_log, on=_state(on_sys), log=on_log,
                spans=recorded, counters=counted, sys=on_sys)


@pytest.fixture(scope="module")
def mono_frames():
    return ss.render_frames(MONO)


@pytest.fixture(scope="module")
def mono(mono_frames):
    return _both(_mono_drive, mono_frames)


@pytest.fixture(scope="module")
def inertial():
    return _both(_inertial_drive, imu_scene.render_frames(INERTIAL))


DRIVES = ["mono", "inertial"]


def _path(recorded, i):
    names = []
    while i >= 0:
        names.append(recorded[i].name)
        i = recorded[i].parent
    return "/".join(reversed(names))


@pytest.mark.parametrize("drive", DRIVES)
def test_each_frame_has_one_frame_root(drive, request):
    d = request.getfixturevalue(drive)
    recorded = d["spans"]
    roots = [s for s in recorded if s.parent < 0]
    assert [s.name for s in roots] == ["frame"] * len(d["log"])
    assert [s.frame for s in roots] == list(range(len(d["log"])))
    for s in recorded:
        assert s.end_ns is not None and s.end_ns >= s.start_ns and s.self_ns >= 0
        if s.parent >= 0:
            p = recorded[s.parent]
            assert s.frame == p.frame and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("entry", ["stereo", "rgbd", "stereo_inertial"])
def test_depth_entry_points_open_the_frame_root(entry, mono_frames):
    """`track_stereo` (both Systems) and `track_rgbd` open one `frame` span
    a frame with the frame's id, and every span of the frame (its
    extractions included) lies under it."""
    from orbslam3_tpu_torch.pipeline import rgbd_system, stereo_inertial_system, stereo_system

    baseline = 0.11
    cfg = dataclasses.replace(ss.system_config(MONO),
                              stereo_bf=float(MONO.K4[0]) * baseline)
    scfg = stereo_system.StereoConfig(baseline=baseline)
    if entry == "stereo":
        sys_ = stereo_system.StereoSystem(cfg, scfg, device="cpu")
    elif entry == "rgbd":
        sys_ = rgbd_system.RGBDSystem(cfg, scfg, device="cpu")
    else:
        sys_ = stereo_inertial_system.StereoInertialSystem(
            cfg, inertial_system.InertialConfig(), scfg, device="cpu")
    depth = np.full(MONO.hw, 2.0, np.float32)
    profiling.enable()
    try:
        for i in range(3):
            img = mono_frames[i]
            if entry == "rgbd":
                sys_.track_rgbd(img, depth, i / 10.0)
            else:
                sys_.track_stereo(img, np.roll(img, -8, axis=1), i / 10.0)
        recorded = profiling.spans()
    finally:
        profiling.disable()
    roots = [s for s in recorded if s.parent < 0]
    assert [(s.name, s.frame) for s in roots] == [("frame", f) for f in range(3)]
    assert sys_.frame_id == 2
    for s in recorded:
        if s.parent >= 0:
            assert s.frame == recorded[s.parent].frame
    n_extract = 1 if entry == "rgbd" else 2
    for root in range(3):
        assert sum(s.name == "extract" and s.frame == root for s in recorded) == n_extract


@pytest.mark.parametrize("drive", DRIVES)
def test_keyframe_frames_carry_the_keyframe_stages(drive, request):
    d = request.getfixturevalue(drive)
    recorded = d["spans"]
    stages = collections.defaultdict(set)
    for i, s in enumerate(recorded):
        stages[s.frame].add(_path(recorded, i))
    kf_frames = [f for f, (before, after, _) in enumerate(d["log"]) if after > before and before]
    assert len(kf_frames) >= 2
    for f in kf_frames:
        assert {"frame/track/keyframe/" + n for n in
                ("insert_kf", "cull", "window_ba", "post_ba_stages")} <= stages[f], f
    tracked = [f for f in stages if "frame/track" in stages[f]]
    assert all("frame/track/track_local_map/pose_opt" in stages[f] and
               "frame/track/track_local_map/project_match" in stages[f] and
               "frame/track/host_read" in stages[f] for f in tracked)
    assert all({"frame/upload", "frame/extract"} <= p for p in stages.values())
    assert not any("keyframe" in p for f, ps in stages.items() if f not in kf_frames for p in ps)


@pytest.mark.parametrize("drive", DRIVES)
def test_kf_counters_sum_to_the_keyframes_inserted(drive, request):
    d = request.getfixturevalue(drive)
    inserted = [f for f, (before, after, _) in enumerate(d["log"]) if after > before and before]
    by_rule = {k: v for k, v in d["counters"].items() if k.startswith("kf.")}
    assert set(by_rule) <= {"kf.max_frames", "kf.inlier_ratio", "kf.both"}
    assert sorted(f for per in by_rule.values() for f, n in per.items() for _ in range(n)) == \
        inserted
    n_keyframe_spans = sum(s.name == "keyframe" for s in d["spans"])
    assert n_keyframe_spans == len(inserted)


def test_imu_init_spans_fall_at_the_imu_stage_frames(inertial):
    marked = sorted({stage for _, _, stage in inertial["log"] if stage >= 0})
    recorded = inertial["spans"]
    at = [s.frame for s in recorded if s.name == "imu_init"]
    assert at == marked and len(marked) == 2          # the IMU init and VIBA1
    assert inertial["sys"].imu_initialized and inertial["sys"].viba1_done
    for i, s in enumerate(recorded):
        if s.name == "imu_init":
            kids = [c.name for c in recorded if c.parent == i]
            assert kids[0] == "inertial_only_init" and kids[-1] == "full_ba" and \
                "reintegrate" in kids
            assert _path(recorded, i) == "frame/track/keyframe/imu_init"


def test_inertial_branches_and_stages_are_counted(inertial):
    recorded, counted = inertial["spans"], inertial["counters"]
    vi = [s.frame for s in recorded if s.name == "vi_pose_opt"]
    branch = sorted(f for k in ("vi.lastkf", "vi.lastframe") for f in counted.get(k, {}))
    assert vi and vi == branch
    assert "vi.lastkf" in counted and "vi.lastframe" in counted
    assert len(counted.get("vi.rejected", {})) <= len(vi)
    assert len({s.frame for s in recorded if s.name == "preintegrate"}) >= len(vi)
    paths = {_path(recorded, i) for i, s in enumerate(recorded)}
    assert {"frame/imu_rows", "frame/track/vi_pose_opt", "frame/track/preintegrate",
            "frame/track/keyframe/imu_init/reintegrate/preintegrate"} <= paths
    retries = counted.get("track.retry", {})
    assert sorted(retries) == sorted(s.frame for s in recorded if s.name == "track_retry")


@pytest.mark.parametrize("drive", DRIVES)
def test_a_drive_with_tracing_off_reads_no_clock_and_matches_tracing_on(drive, request):
    d = request.getfixturevalue(drive)
    assert d["off_log"] == d["log"]
    (traj_off, map_off), (traj_on, map_on) = d["off"], d["on"]
    np.testing.assert_array_equal(traj_off, traj_on)
    for k in map_off:
        assert torch.equal(map_off[k], map_on[k]), k


def test_spans_counters_and_self_time():
    assert profiling.span("x") is profiling.span("y")
    assert profiling.count("x") is None and profiling.spans() == [] and profiling._TRACER is None
    profiling.enable()
    try:
        with profiling.span("frame", 7):
            profiling.count("kf.both")
            with profiling.span("a"):
                time.sleep(0.002)
                with profiling.span("b"):
                    time.sleep(0.003)
        with profiling.span("outside"):
            profiling.count("kf.both", 2)
        rec = profiling.spans()
        assert [(s.name, s.frame, s.parent) for s in rec] == \
            [("frame", 7, -1), ("a", 7, 0), ("b", 7, 1), ("outside", None, -1)]
        a, b = rec[1], rec[2]
        assert a.self_ns == (a.end_ns - a.start_ns) - (b.end_ns - b.start_ns)
        assert a.self_ns >= 2e6 and b.self_ns >= 3e6
        assert profiling.counters() == {"kf.both": {7: 1, None: 2}}
        profiling.reset()
        assert profiling.spans() == [] and profiling.counters() == {}
    finally:
        profiling.disable()
    assert profiling.spans() == [] and profiling._TRACER is None


def test_sync_warnings_count_in_the_innermost_span():
    def sync_warning():
        warnings.warn(profiling.SYNC_WARNING, UserWarning)

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        filters = list(warnings.filters)
        profiling.enable()
        try:
            sync_warning()
            with profiling.span("frame", 3):
                with profiling.span("track"):
                    for _ in range(3):
                        sync_warning()          # the same line: each one counts
                    with profiling.span("host_read"):
                        sync_warning()
                sync_warning()
                warnings.warn("another warning")
            rec = profiling.spans()
            assert [(s.name, s.host_reads) for s in rec] == \
                [("frame", 1), ("track", 3), ("host_read", 1)]
            assert profiling.counters()["host_reads"] == {None: 1, 3: 5}
        finally:
            profiling.disable()
        assert list(warnings.filters) == filters
        sync_warning()
    assert [str(w.message) for w in seen] == ["another warning", profiling.SYNC_WARNING]


def _synthetic_trace(launch_us, call_us=(3.0, 3.0)):
    """A Chrome trace with the anchor kernel launched at each of
    `launch_us` (runtime calls lasting `call_us`) and one other kernel."""
    ev = []
    for k, (ts, dur) in enumerate(zip(launch_us, call_us)):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": dur,
                   "args": {"correlation": 100 + k}})
        ev.append({"cat": "kernel", "name": "orb_empty_kernel()", "ts": ts + dur + 3.0,
                   "dur": 1.0, "args": {"correlation": 100 + k}})
    ev.append({"cat": "kernel", "name": "other", "ts": 5.0, "dur": 1.0,
               "args": {"correlation": 7}})
    return {"traceEvents": ev}


def test_align_maps_a_synthetic_trace():
    # host brackets of 20 and 40 us around launch calls of 3 us that start
    # at trace us 1000 and 21000.4: each call starts 8.5 / 18.5 us into its
    # bracket, give or take 8.5 / 18.5 us
    anchors = [(5_000_000, 5_020_000), (25_000_000, 25_040_000)]
    trace = _synthetic_trace([1000.0, 21000.4])
    al = profiling.align(trace, anchors)
    assert al.widths_ns == [20_000, 40_000] and al.errors_ns == [8_500, 18_500]
    assert al.kept == [0, 1]
    assert al.to_trace_us(5_008_500) == pytest.approx(1000.0)
    assert al.to_trace_us(25_018_500) == pytest.approx(21000.4)
    assert al.us_per_ns == pytest.approx(20000.4 / 20_010_000)
    assert al.to_host_ns(al.to_trace_us(12_345_678)) == pytest.approx(12_345_678)
    # a first launch call that took 2 ms of its 2.01 ms bracket
    slow = profiling.align(_synthetic_trace([1000.0, 21000.4], (2000.0, 3.0)),
                           [(5_000_000, 7_010_000), (25_000_000, 25_040_000)])
    assert slow.errors_ns == [5_000, 18_500]
    assert slow.to_trace_us(5_005_000) == pytest.approx(1000.0)
    # three anchors 100 and 150 us apart, one of whose launches the trace lost
    three = [(5_000_000, 5_020_000), (5_100_000, 5_120_000), (5_250_000, 5_270_000)]
    lost = profiling.align(_synthetic_trace([1000.0, 1250.0]), three)
    assert lost.kept == [0, 2] and lost.us_per_ns == pytest.approx(1e-3)
    assert profiling.align(_synthetic_trace([1000.0, 1100.0]), three).kept == [0, 1]
    assert profiling.align(_synthetic_trace([1000.0, 1150.0]), three).kept == [1, 2]
    # two anchors and one launch fit either way: the tie keeps the first
    assert profiling.align(_synthetic_trace([1000.0]), anchors).kept == [0]
    with pytest.raises(ValueError):
        # four anchors and one launch: more lost than MAX_LOST allows
        profiling.align(_synthetic_trace([1000.0]), three + [(5_400_000, 5_420_000)])
    with pytest.raises(ValueError):
        profiling.align(trace, anchors[:1])
    rec = [profiling.Span("frame", 0, -1, 6_000_000, 8_000_000, 2_000_000, 0),
           profiling.Span("open", 0, 0, 7_000_000, None, None, 0)]
    profiling.add_spans(trace, al, rec)
    mine = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert len(mine) == 1 and mine[0]["name"] == "frame"
    assert mine[0]["ts"] == pytest.approx(al.to_trace_us(6_000_000))
    assert mine[0]["dur"] == pytest.approx(2_000_000 * al.us_per_ns)
    meta = [e for e in trace["traceEvents"] if e.get("ph") == "M"]
    assert meta[0]["args"]["name"] == "program spans" and meta[0]["pid"] == mine[0]["pid"]


def test_stage_timer_records_its_stages_as_spans():
    timer = profiling.StageTimer()
    profiling.enable()
    try:
        with timer.stage("extract"):
            time.sleep(0.001)
        rec = profiling.spans()
    finally:
        profiling.disable()
    assert [s.name for s in rec] == ["extract"] and len(timer.times["extract"]) == 1
    again = profiling.StageTimer.from_spans(rec)
    assert again.times["extract"][0] == pytest.approx((rec[0].end_ns - rec[0].start_ns) / 1e9)


# ------------------------------------------------------------------ the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the anchor is a CUDA kernel)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_anchors_map_a_host_sleep_onto_the_device_gap(dev):
    """Two anchors around a 5 ms sleep in a span: at least 95% of the
    device's idle gap after the first anchor's kernel maps, through the two
    anchors, inside the span, and each anchor's bracket is under 50 us.
    Under the profiler a launch after 0.2 ms or more without one spends
    40-100 us in the driver's launch call (the first of a profile
    milliseconds), so each anchor follows a launch of the same kernel
    (`warm`; the one after the sleep ends the span), and those launches are
    taken out of the trace before the map is made."""
    from orbslam3_tpu_torch.ops import orb_patches

    def warm():
        orb_patches.empty_kernel(dev)

    profiling.device_anchor(dev)                 # builds and loads the kernel
    torch.cuda.synchronize()
    profiling.enable()
    try:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            warm()
            warm()
            a0 = profiling.device_anchor(dev)
            with profiling.span("sleep"):
                time.sleep(0.005)
                warm()
            a1 = profiling.device_anchor(dev)
            torch.cuda.synchronize()
        rec = profiling.spans()
    finally:
        profiling.disable()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    ev = trace["traceEvents"]
    _, corr = profiling.anchor_launches(trace)
    launches = sorted((e for e in ev if e.get("cat") == "cuda_runtime"
                       and e.get("args", {}).get("correlation") in corr), key=lambda e: e["ts"])
    assert len(launches) == 5
    order = [e["args"]["correlation"] for e in launches]       # warm, warm, a0, warm, a1
    kernel = {e["args"]["correlation"]: e for e in ev if e.get("cat") == "kernel"}
    warm_ops = [kernel[c] for c in (order[0], order[1], order[3])]
    trace["traceEvents"] = [e for e in ev if e.get("args", {}).get("correlation") not in
                            (order[0], order[1], order[3])]
    al = profiling.align(trace, [a0, a1])
    k0, k1 = kernel[order[2]], kernel[order[4]]
    # the idle gap after a0's kernel ends where the warm launch's kernel starts
    g0, g1 = al.to_host_ns(k0["ts"] + k0["dur"]), al.to_host_ns(warm_ops[2]["ts"])
    s = rec[0]
    inside = max(0.0, min(g1, s.end_ns) - max(g0, s.start_ns))
    lead = [kernel[c]["ts"] - e["ts"] for c, e in zip(order, launches)]
    print(f"anchor brackets {[w / 1e3 for w in al.widths_ns]} us, error bounds "
          f"{[e / 1e3 for e in al.errors_ns]} us, launch calls {[e['dur'] for e in launches]} us, "
          f"kernel start less launch call start {lead} us, gap {(g1 - g0) / 1e6:.4f} ms, "
          f"inside the span {inside / (g1 - g0):.4f}, us per ns {al.us_per_ns:.9f}")
    assert g1 - g0 >= 5e6 and inside >= 0.95 * (g1 - g0)
    assert all(w < 50_000 for w in al.widths_ns)
    assert k1["ts"] > warm_ops[2]["ts"]


@pytest.mark.gpu
def test_host_reads_equal_the_sync_census(dev):
    """The tracer's `host_reads` in each tracked frame of the small seeded
    drive equal `sync_census`'s count of the same frame on the same drive."""
    from orbslam3_tpu_torch.utils import sync_census

    frames = ss.render_frames(MONO)
    census = []
    with sync_census._sync_warnings(census):
        sys_ = system.System(ss.system_config(MONO), device=dev)
        per_frame = []
        for fi in MONO.track_frames:
            census.clear()
            sys_.track_monocular(frames[fi], fi / 10.0)
            per_frame.append(len(census))
    profiling.enable()
    try:
        _, log = _mono_drive(frames, dev)
        counted = profiling.counters().get("host_reads", {})
        recorded = profiling.spans()
    finally:
        profiling.disable()
    tracked = sorted({s.frame for s in recorded if s.name == "track"})
    assert len(tracked) >= 10
    assert [counted.get(f, 0) for f in tracked] == [per_frame[f] for f in tracked]
    assert all(counted.get(f, 0) >= 1 for f in tracked)


@pytest.mark.gpu
def test_trace_writes_the_spans_over_the_kernels(dev, tmp_path):
    """`profiling.trace()` on the card: its anchors place the enclosed
    spans on the trace's clock, over the kernels they launched."""
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        with profiling.span("frame", 0):
            for _ in range(20):
                x = x * 1.0001
            torch.cuda.synchronize()
    with open(tmp_path / "trace.json") as f:
        ev = json.load(f)["traceEvents"]
    frame = [e for e in ev if e.get("cat") == "program_span"]
    assert [e["name"] for e in frame] == ["frame"]
    launches = [e for e in ev if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]]
    t0, t1 = frame[0]["ts"], frame[0]["ts"] + frame[0]["dur"]
    mul = [e for e in launches if t0 <= e["ts"] <= t1]
    calls, _ = profiling.anchor_launches({"traceEvents": ev})
    assert len(mul) >= 20, (len(mul), t0, t1, calls, [e["ts"] for e in launches])
