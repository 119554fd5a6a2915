"""The port's dataset IO against the JAX package's: the ASL-layout reader,
the undistortion remap, the native ingest (decode -> remap -> resize ->
CLAHE), the sensor pump and its EuRoC playback.

Every comparison is exact (bit-equal arrays, equal Python floats): the two
packages run the same NumPy code, and both compile the same `ingest.cpp`
with the same flags.  The trees are written with numpy from a seed, once
from t = 0 and once at MH_01's first stamp (1403636579763555584 ns), where
a float32 timestamp would be off by up to 64 s.
"""

import os
import threading

import numpy as np
import pytest
import torch

from orbslam3_tpu.io import euroc as jeuroc
from orbslam3_tpu.io import native_ingest as jni
from orbslam3_tpu.io import pump as jpump
from orbslam3_tpu_torch.io import euroc as teuroc
from orbslam3_tpu_torch.io import native_ingest as tni
from orbslam3_tpu_torch.io import pump as tpump

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH_NS = 1403636579763555584          # EuRoC MH_01's first camera stamp
STARTS = {"zero": 0, "epoch": EPOCH_NS}


def _write_png(path, img):
    from PIL import Image
    Image.fromarray(np.asarray(img).astype(np.uint8), mode="L").save(path)


def _write_tree(root, t0_ns, n_img=5, hw=(48, 64), imu_lead_s=0.1, gt=True):
    """A mini ASL tree: n_img PNGs at 20 Hz from t0_ns, a 200 Hz IMU from
    `imu_lead_s` before the first image, and a 100 Hz ground truth."""
    mav = os.path.join(root, "mav0")
    os.makedirs(os.path.join(mav, "cam0", "data"))
    os.makedirs(os.path.join(mav, "imu0"))
    rng = np.random.default_rng(0)
    rows = ["#timestamp [ns],filename"]
    for i in range(n_img):
        ts = t0_ns + i * 50_000_000
        name = f"{ts}.png"
        _write_png(os.path.join(mav, "cam0", "data", name), rng.integers(0, 255, hw))
        rows.append(f"{ts},{name}")
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    imu = ["#timestamp,wx,wy,wz,ax,ay,az"]
    start = t0_ns - int(imu_lead_s * 1e9)
    for k in range(int((n_img * 0.05 + imu_lead_s) * 200) + 4):
        g = rng.normal(0, 0.1, 3)
        a = rng.normal(0, 0.5, 3) + np.array([0, 0, 9.81])
        imu.append(f"{start + k * 5_000_000}," + ",".join(f"{v:.9f}" for v in (*g, *a)))
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("\n".join(imu) + "\n")
    if gt:
        os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"))
        g_rows = ["#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z"]
        for k in range(n_img * 5):
            p = rng.normal(0, 1, 3)
            g_rows.append(f"{t0_ns + k * 10_000_000},{p[0]},{p[1]},{p[2]},1,0,0,0")
        with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), "w") as f:
            f.write("\n".join(g_rows) + "\n")
    return root


def _within(seconds, fn):
    """fn() on a thread; fails if it does not return within `seconds`."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:   # re-raised below
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=seconds)
    assert not th.is_alive(), f"did not finish within {seconds} s"
    if err:
        raise err[0]
    return out[0]


# ------------------------------------------------------------------ reader
@pytest.mark.parametrize("start", sorted(STARTS))
def test_euroc_sequence_matches_jax(tmp_path, start):
    root = _write_tree(str(tmp_path), STARTS[start])
    j, t = jeuroc.EurocSequence(root), teuroc.EurocSequence(root)
    assert [(r.ts, r.path) for r in t.images] == [(r.ts, r.path) for r in j.images]
    assert all(type(r.ts) is float for r in t.images)
    assert len(t.imu) == len(j.imu) > 0
    for rt, rj in zip(t.imu, j.imu):
        assert rt.ts == rj.ts
        assert rt.gyro.dtype == rj.gyro.dtype == np.float32
        np.testing.assert_array_equal(rt.gyro, rj.gyro)
        np.testing.assert_array_equal(rt.acc, rj.acc)
    for a, b in zip(t.read_groundtruth(), j.read_groundtruth()):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    t0, t1 = t.images[1].ts, t.images[3].ts
    assert [r.ts for r in t.imu_between(t0, t1)] == [r.ts for r in j.imu_between(t0, t1)]
    for (ta, ia), (tb, ib) in zip(t.frames(), j.frames()):
        assert ta == tb
        assert ia.dtype == ib.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)
    if start == "epoch":
        # consecutive frames 50 ms apart stay 50 ms apart (float32 would
        # put them on one 128 s grid)
        assert abs(t.images[1].ts - t.images[0].ts - 0.05) < 1e-6


@pytest.mark.parametrize("new_params", [None, (430.0, 428.0, 370.0, 250.0)])
def test_undistort_map_and_remap_bit_equal(new_params):
    cam = teuroc.EUROC_CAM0
    args = (cam["params"], cam["distortion"], cam["resolution"], new_params)
    mt, mj = teuroc.undistort_map(*args), jeuroc.undistort_map(*args)
    assert mt.dtype == np.float32 and mt.shape == (480, 752, 2)
    np.testing.assert_array_equal(mt, mj)
    img = np.random.default_rng(1).integers(0, 256, cam["resolution"]).astype(np.float32)
    np.testing.assert_array_equal(teuroc.apply_undistort(img, mt),
                                  jeuroc.apply_undistort(img, mj))


# ------------------------------------------------------------ native ingest
def _ingest_cases(tmp_path):
    """test_io.py's three pipelines and EuRoC's undistortion + CLAHE at
    full size: (paths, positional and keyword arguments)."""
    rng = np.random.default_rng(0)
    cases = {}
    p = str(tmp_path / "f.png")
    _write_png(p, rng.integers(0, 255, (96, 128)))
    cases["resize_clahe"] = ([p], ((96, 128),), dict(resize_hw=(48, 64), clahe_clip=3.0,
                                                      clahe_grid=4))
    p = str(tmp_path / "g.png")
    _write_png(p, rng.integers(0, 255, (64, 80)))
    ys, xs = np.mgrid[0:64, 0:80].astype(np.float32)
    cases["remap_resize"] = ([p], ((64, 80),), dict(remap=np.stack([xs, ys], -1),
                                                     src_hw=(64, 80), resize_hw=(32, 40)))
    p = str(tmp_path / "h.png")
    _write_png(p, rng.integers(0, 255, (32, 32)))
    cases["size_mismatch"] = ([p], ((16, 16),), dict(src_hw=(16, 16)))
    cam = teuroc.EUROC_CAM0
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"e{i}.png"))
        _write_png(paths[-1], rng.integers(0, 255, cam["resolution"]))
    umap = teuroc.undistort_map(cam["params"], cam["distortion"], cam["resolution"])
    cases["euroc_undistort_clahe"] = (paths, (cam["resolution"], umap),
                                      dict(src_hw=cam["resolution"], clahe_clip=3.0))
    return cases


@pytest.mark.parametrize("case", ["resize_clahe", "remap_resize", "size_mismatch",
                                  "euroc_undistort_clahe"])
def test_native_ingest_bit_equal_to_jax(tmp_path, case):
    assert tni.available(), tni.build_error()
    assert jni.available()
    paths, args, kw = _ingest_cases(tmp_path)[case]
    it = tni.NativeIngest(paths, *args, n_threads=2, **kw)
    ij = jni.NativeIngest(paths, *args, n_threads=2, **kw)
    got, want = list(it), list(ij)
    assert it.failed == ij.failed == (1 if case == "size_mismatch" else 0)
    it.close()
    ij.close()
    assert len(got) == len(want) == len(paths)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if case == "euroc_undistort_clahe":
        # bilinear frames carry fractions: nothing rounds them to uint8
        assert np.any(got[0] != np.round(got[0]))


def test_native_ingest_is_built_from_the_ports_source():
    lib = tni._lib()
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.join(REPO, "orbslam3_tpu_torch", "build") + os.sep), path
    assert "orbslam3_tpu/native" not in path
    with open(tni.SOURCE, "rb") as a, \
            open(os.path.join(REPO, "orbslam3_tpu", "native", "ingest.cpp"), "rb") as b:
        assert a.read() == b.read()      # an unedited copy


def test_native_ingest_build_failure_is_reported(monkeypatch):
    def broken():
        raise RuntimeError("g++ failed (1): png.h: No such file or directory")

    monkeypatch.setattr(tni, "_LIB", None)
    monkeypatch.setattr(tni, "_ERROR", None)
    monkeypatch.setattr(tni, "build", broken)
    assert not tni.available()
    assert "png.h" in tni.build_error()
    with pytest.raises(RuntimeError, match="png.h"):
        tni.NativeIngest([], (4, 4))


# -------------------------------------------------------------- sensor pump
def _feeds(case):
    """test_io.py's pump scenarios as (constructor kwargs, sync kwargs,
    producer(pump))."""
    if case == "imu_batching_timeshift":
        def produce(p):
            for k in range(100):
                p.feed_imu(k * 0.005, np.full(3, k, np.float32), np.zeros(3))
            for i in range(8):
                p.feed_image(i * 0.05, np.full((4, 4), i, np.float32))
            p.finish()
        return dict(timeshift_cam_imu=0.005), {}, produce
    if case == "gnss_window":
        def produce(p):
            p.feed_imu(10.0, np.zeros(3), np.zeros(3))
            p.feed_gnss(0.30, np.array([1.0, 2.0, 3.0]))
            p.feed_gnss(0.52, np.array([4.0, 5.0, 6.0]))
            for i in range(6):
                p.feed_image(i * 0.1, np.zeros((2, 2), np.float32))
            p.finish()
        return {}, dict(require_imu=False, gnss_window=0.03), produce
    if case == "epoch_timeshift":
        t0 = EPOCH_NS * 1e-9

        def produce(p):
            for k in range(60):
                p.feed_imu(t0 - 0.02 + k * 0.005, np.zeros(3), np.full(3, k, np.float32))
            for i in range(5):
                p.feed_image(t0 + i * 0.05, np.zeros((2, 2), np.float32))
            p.feed_gnss(t0 + 0.101, np.array([7.0, 8.0, 9.0]))
            p.finish()
        return dict(timeshift_cam_imu=-0.0031), {}, produce

    def produce(p):
        for i in range(30):
            p.feed_imu(i * 0.01, np.zeros(3), np.zeros(3))
            if i % 3 == 2:
                p.feed_image(i * 0.01 - 0.005, np.zeros((2, 2), np.float32))
        p.finish()
    return {}, {}, produce


def _frames_key(frames):
    return [(f.ts, f.index, f.image.tobytes(),
             [(t, g.tobytes(), a.tobytes()) for t, g, a in f.imu],
             None if f.gnss is None else f.gnss.tobytes()) for f in frames]


def _run_pump(mod, case, threaded):
    kw, sync_kw, produce = _feeds(case)
    p = mod.SensorPump(**kw)
    if threaded:
        th = threading.Thread(target=produce, args=(p,), daemon=True)
        th.start()
        frames = list(p.sync(**sync_kw))
        th.join(timeout=10)
    else:
        produce(p)
        frames = list(p.sync(**sync_kw))
    return frames


@pytest.mark.parametrize("case,threaded", [("imu_batching_timeshift", False),
                                           ("gnss_window", False),
                                           ("threaded_producer", True),
                                           ("epoch_timeshift", True)])
def test_sensor_pump_matches_jax(case, threaded):
    ft = _within(30, lambda: _run_pump(tpump, case, threaded))
    fj = _within(30, lambda: _run_pump(jpump, case, threaded))
    assert len(ft) > 0
    assert _frames_key(ft) == _frames_key(fj)
    if case == "gnss_window":
        assert [None if f.gnss is None else f.gnss[0] for f in ft][3:] == [1.0, None, 4.0]


@pytest.mark.parametrize("start", sorted(STARTS))
def test_pump_euroc_matches_jax(tmp_path, start):
    """test_io.py's mini tree through both packages' playback: native
    decode + CLAHE + IMU batching, the same frames and batches."""
    root = _write_tree(str(tmp_path), STARTS[start] or 1_000_000_000, gt=False)
    ft = _within(60, lambda: list(tpump.pump_euroc(teuroc.EurocSequence(root),
                                                   clahe_clip=2.0, n_threads=2)))
    fj = _within(60, lambda: list(jpump.pump_euroc(jeuroc.EurocSequence(root),
                                                   clahe_clip=2.0, n_threads=2)))
    assert len(ft) == 5 and all(f.image.shape == (48, 64) for f in ft)
    assert all(len(f.imu) > 0 for f in ft)
    assert _frames_key(ft) == _frames_key(fj)


def test_pump_euroc_raises_when_its_producer_fails(tmp_path, monkeypatch):
    """The host path's producer thread dies on a missing image: the frames
    before it are consumed, then the failure is raised (the JAX package's
    consumer waits forever there)."""
    root = _write_tree(str(tmp_path), 1_000_000_000, gt=False)
    seq = teuroc.EurocSequence(root)
    seq.images[2].path += ".missing"
    monkeypatch.setattr(tni, "_LIB", None)
    monkeypatch.setattr(tni, "_ERROR", "native ingest library unavailable: test")
    seen = []

    def consume():
        for fr in tpump.pump_euroc(seq, n_threads=2):
            seen.append(fr.index)

    with pytest.raises(RuntimeError, match="producer failed"):
        _within(60, consume)
    assert seen == [0, 1]
