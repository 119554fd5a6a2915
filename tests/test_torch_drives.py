"""The port's remaining drives against the JAX drives they port.

`utils/synthetic_world.py` against the fixtures of `tests/test_pipeline_e2e.py`
and `tests/test_inertial_pipeline.py` (frames bit for bit, paths within 1e-6);
`drive_vi_loop`'s circuit, IMU samples and stressed frames against the JAX
drive's (bit for bit); chain B of `drive_vi_chain_ablation` (preintegration
and prediction) against JAX's on the same packed rows (1e-5); each drive's
`main` on the CPU at a cut size, printing the JAX drive's lines, and
refusing a card that is not there.  The whole drives on the CPU are marked
slow.
"""

import importlib
import importlib.util
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu.utils import synth_render as jsr
from orbslam3_tpu_torch.ops import imu as timu
from orbslam3_tpu_torch.ops import orb_patches
from orbslam3_tpu_torch.pipeline import inertial_system
from orbslam3_tpu_torch.tools.drives import (drive_extract_bench, drive_kf_times,
                                             drive_vi_chain_ablation, drive_vi_gnss,
                                             drive_vi_loop)
from orbslam3_tpu_torch.utils import synthetic_world as sw
from test_inertial_pipeline import camera_path_smooth as jax_camera_path_smooth
from test_pipeline_e2e import SyntheticWorld as JaxWorld
from test_pipeline_e2e import camera_path as jax_camera_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_drive(name):
    """The JAX drive `tools/drives/<name>.py` as a module (its top level
    imports NumPy only; JAX comes in with `main`)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", "drives", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- worlds
def test_camera_paths_match_the_jax_fixtures():
    for (Rj, tj, wj), (Rt, tt, wt) in zip(jax_camera_path(60), sw.camera_path(60)):
        np.testing.assert_allclose(Rt, Rj, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tt, tj, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(wt, wj)
    fj, *jf = jax_camera_path_smooth(40)
    ft, *tf = sw.camera_path_smooth(40)
    for a, b in zip(fj, ft):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for t in np.linspace(0.0, 2.0, 7):
        for gj, gt in zip(jf, tf):
            np.testing.assert_array_equal(gt(t), gj(t))


@pytest.mark.parametrize("path", ["camera_path", "camera_path_smooth"])
def test_synthetic_world_frames_bit_equal_to_the_jax_fixture(path):
    """Same seed, same poses: the same keypoints, descriptors (int32 bit
    patterns of JAX's uint32) and validity, frame after frame."""
    if path == "camera_path":
        poses = [(R, t) for R, t, _ in jax_camera_path(6)]
        seed = 2
    else:
        poses = [(f[0], f[1]) for f in jax_camera_path_smooth(6)[0]]
        seed = 3
    wj, wt = JaxWorld(seed=seed), sw.SyntheticWorld(seed=seed)
    for R_cw, t_cw in poses:
        fj, ft = wj.frame(R_cw, t_cw), wt.frame(R_cw, t_cw)
        np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
        np.testing.assert_array_equal(ft.desc.numpy(), np.asarray(fj.desc).view(np.int32))
        np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
        np.testing.assert_array_equal(ft.response.numpy(), np.asarray(fj.response))
        assert ft.desc.dtype == torch.int32 and ft.octave.dtype == torch.int32
        assert int(ft.valid.sum()) > 100


def test_imu_between_matches_the_jax_drives_loop():
    """The samples the drives feed `grab_imu`, as JAX's drives compute them
    inline (drive_vi_gnss.py:66-75)."""
    _, pos, vel, acc, rot, rot_rate = jax_camera_path_smooth(3)
    dt_f, dt_i = 1.0 / sw.FPS, 1.0 / sw.IMU_HZ
    for i in (1, 2, 17):
        t_frame, t0 = i * dt_f, (i - 1) * dt_f
        ref = []
        k = 1
        while t0 + k * dt_i <= t_frame + 1e-9:
            tm = t0 + k * dt_i
            Rb = rot(tm - 0.5 * dt_i)
            ref.append((tm, rot_rate(tm - 0.5 * dt_i), Rb.T @ (acc(tm - 0.5 * dt_i) - sw.G)))
            k += 1
        got = sw.imu_between(t0, t_frame, rot, acc, rot_rate)
        assert len(got) == len(ref) == 10
        for a, b in zip(got, ref):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])


# --------------------------------------------------------- the VI loop lap
def test_vi_loop_circuit_and_imu_match_the_jax_drive():
    J = _jax_drive("drive_vi_loop")
    T = drive_vi_loop
    for t in np.linspace(0.0, 15.0, 31):
        for f in ("rho", "center", "accel_w", "heading", "heading_rate"):
            np.testing.assert_array_equal(getattr(T, f)(t), getattr(J, f)(t))
        for a, b in zip(T.pose(t), J.pose(t, jsr)):
            np.testing.assert_array_equal(a, b)
    dt_i = 1.0 / J.IMU_HZ
    for i in (1, 2, 77, 299):
        t_frame, t_prev = i / J.FPS, (i - 1) / J.FPS
        ref = []
        k = 1
        while t_prev + k * dt_i <= t_frame + 1e-9:       # drive_vi_loop.py:148-157
            tm = t_prev + k * dt_i
            ts_mid = tm - 0.5 * dt_i
            R_cw, _ = J.pose(ts_mid, jsr)
            ref.append((tm, np.array([0.0, 0.0, J.heading_rate(ts_mid)]),
                        R_cw @ (J.accel_w(ts_mid) - J.G_W)))
            k += 1
        got = T.imu_samples(i)
        assert len(got) == len(ref) == 10
        for a, b in zip(got, ref):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])


def test_vi_loop_rendered_stressed_frames_match_the_jax_drive():
    """Frames 48 (plain) and 49-50 (stressed, from the shared generator) of
    both drives, rendered in order: bit for bit.  JAX's frames come from
    its `main`'s closure (drive_vi_loop.py:83-106), written out here."""
    J = _jax_drive("drive_vi_loop")
    rng = np.random.default_rng(9)
    tex = jsr.block_texture(rng, block=10)
    mesas = jsr.default_mesas(rng)
    lap_frames = int(J.LAP_S * J.FPS)

    def jax_render(i):
        R_cw, t_cw = J.pose(i / J.FPS, jsr)
        img = jsr.render_plane(R_cw, t_cw, np.asarray(drive_vi_loop.K4), drive_vi_loop.HW,
                               tex, tex_scale=40.0, mesas=mesas)
        u = (i % lap_frames) / lap_frames
        if 0.2 < u < 0.8:
            img = jsr.photometric_stress(
                img, exposure=0.65, gamma=1.1, vignette=0.3,
                blur_px=2.0 if i % 3 == 0 else 0.0, blur_dir=(1.0, 0.4),
                noise=4.0, rng=rng)
        return img

    scene = drive_vi_loop.make_scene()
    for i in (48, 49, 50):
        np.testing.assert_array_equal(drive_vi_loop.render(i, *scene), jax_render(i))


def test_vi_loop_scene_functions_import_no_jax():
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['orbslam3_tpu'] = None\n"
            "from orbslam3_tpu_torch.tools.drives import drive_vi_loop as d\n"
            "s = d.make_scene()\nimg = d.render(50, *s)\nassert img.shape == d.HW\n"
            "assert len(d.imu_samples(3)) == 10\n"
            "assert 'jax' not in [m.split('.')[0] for m, v in sys.modules.items() if v]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr


# ------------------------------------------------------ the chain ablation
def test_chain_b_preintegration_and_prediction_match_jax():
    """Chain B's IMU half on the ablation's own packed rows: the port
    integrates the valid rows, JAX scans all 64 under the mask; the predicted
    state agrees within 1e-5."""
    icfg = inertial_system.InertialConfig(imu_freq=drive_vi_chain_ablation.IMU_HZ)
    noise = (icfg.noise_gyro, icfg.noise_acc, icfg.walk_gyro, icfg.walk_acc, icfg.imu_freq)
    cal_t, cal_j = timu.ImuCalib.create(*noise), jimu.ImuCalib.create(*noise)
    rows = drive_vi_chain_ablation.measure_rows(80, 3, icfg.max_imu_per_frame)
    rng = np.random.default_rng(5)
    bias = rng.normal(0, 0.01, 6).astype(np.float32)
    Rwb = np.asarray(jsr.look_down_pose(1.0, 2.0, 5.0, yaw=0.3)[0]).T.astype(np.float32)
    pwb = np.array([1.0, 2.0, -5.0], np.float32)
    vel = np.array([0.3, 0.05, 0.1], np.float32)
    for packed in rows:
        n = inertial_system._n_rows(packed)
        assert 15 <= n < packed.shape[0]
        pt = torch.from_numpy(packed[:n])
        st_t = timu.preintegrate(pt[:, 0:3], pt[:, 3:6], pt[:, 6], pt[:, 7] > 0.5, cal_t,
                                 torch.from_numpy(bias), n_valid=n)
        got = timu.predict_state(*(torch.from_numpy(x) for x in (Rwb, pwb, vel, bias)), st_t)
        pj = jnp.asarray(packed)
        st_j = jimu.preintegrate(pj[:, 0:3], pj[:, 3:6], pj[:, 6], pj[:, 7] > 0.5, cal_j,
                                 jnp.asarray(bias))
        ref = jimu.predict_state(*(jnp.asarray(x) for x in (Rwb, pwb, vel, bias)), st_j)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_chain_ablation_at_a_cut_size_prints_the_jax_lines(capsys):
    """Without an IMU initialization (the cap comes first) the drive says so,
    still times the three chains, prints JAX's lines and exits 1."""
    orb_patches.reset_counters()
    rc = drive_vi_chain_ablation.main(["--device", "cpu", "--cap", "3", "--measure", "7"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "warm-up: IMU NOT initialized within 3 frames" in out
    for line in ("A extract+track            :", "B + preint(", "C fused _vi_track_step     :",
                 "preint+predict cost:", "retry-cond + VI opt cost:",
                 "blocking reads per frame: not measured (no CUDA device)"):
        assert line in out, line
    assert set(orb_patches.launch_counts().values()) == {0}      # CPU: the twins


# ---------------------------------------------------------- cut-size mains
def test_extract_bench_prints_the_jax_lines_and_no_device_time_on_the_cpu(capsys):
    res = drive_extract_bench.main(["3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu"
    assert out[1].startswith("compile+first: ") and "(n_valid 1200)" in out[1]
    assert out[2].startswith("dependent chain: ") and out[2].endswith("fps)")
    assert out[3] == "device time: not measured (no CUDA device)"
    assert res["device_ms"] is None and res["iters"] == 3


def test_extract_bench_frames_match_the_jax_drive():
    rng = np.random.default_rng(0)          # drive_extract_bench.py:33-40
    base = rng.integers(0, 255, (480 // 8, 752 // 8))
    tex = np.kron(base, np.ones((8, 8))).astype(np.float32)
    ref = [np.clip(tex + rng.normal(0, 8, (480, 752)), 0, 255).astype(np.uint8)
           for _ in range(3)]
    for a, b in zip(drive_extract_bench.make_frames(3), ref):
        np.testing.assert_array_equal(a, b)


def test_vi_loop_at_a_cut_size_prints_the_jax_lines_and_dumps_its_run(tmp_path, capsys,
                                                                     monkeypatch):
    dump = str(tmp_path / "run.npz")
    monkeypatch.setenv("DRIVE_FRAMES", "24")
    monkeypatch.setenv("DRIVE_DUMP", dump)
    rc = drive_vi_loop.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1 and out.rstrip().endswith("DRIVE FAIL")
    for line in ("frame 0: state=", "frames OK: ", "imu_initialized: False  loops: 0",
                 "post-loop ATE (2nd half): ", "corrected segment rmse ", "wall: "):
        assert line in out, line
    d = np.load(dump)
    assert d["est"].shape[1] == 3 and d["gt"].shape == d["est"].shape
    assert d["inl"].shape == (24,) and int(d["loop_frame"]) == -1
    assert d["kf_R"].shape[1:] == (3, 3) and int(d["n_kf"]) >= 2


def test_vi_gnss_at_a_cut_size_stops_at_the_jax_assert(capsys):
    """12 frames are too few for the IMU initialization: the drive stops at
    the JAX drive's assert, after its frame line."""
    with pytest.raises(AssertionError, match="IMU init never ran"):
        drive_vi_gnss.main(["--frames", "12", "--device", "cpu"])
    assert "frame 0: state=" in capsys.readouterr().out


def test_kf_times_at_a_cut_size_prints_the_jax_lines(capsys):
    rc = drive_kf_times.main(["--frames", "14", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("visual: tracked ") and "resets=0" in out[1]
    assert out[2].startswith("inertial: tracked ") and "imu_init=False" in out[2]
    assert out[3].startswith("inertial-KF minus visual-KF: ")
    assert out[4] == "DRIVE FAIL" and rc == 1


@pytest.mark.parametrize("name", ["drive_extract_bench", "drive_kf_times", "drive_vi_gnss",
                                  "drive_vi_loop", "drive_vi_chain_ablation"])
def test_drive_refuses_the_card_without_one(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module("orbslam3_tpu_torch.tools.drives." + name)
    with pytest.raises(SystemExit):
        mod.main([])
    assert "pass --device cpu" in capsys.readouterr().err


# ------------------------------------------------------ whole drives: slow
@pytest.mark.slow
def test_vi_gnss_whole_drive_on_the_cpu(capsys):
    assert drive_vi_gnss.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("DRIVE OK")


@pytest.mark.slow
def test_kf_times_whole_drive_on_the_cpu(capsys):
    assert drive_kf_times.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("DRIVE PASS")


@pytest.mark.slow
def test_vi_loop_whole_drive_on_the_cpu(capsys):
    rc = drive_vi_loop.main(["--device", "cpu"])
    out = capsys.readouterr().out
    print(out)
    assert rc == 0 and out.rstrip().endswith("DRIVE PASS")


@pytest.mark.slow
def test_chain_ablation_whole_drive_on_the_cpu(capsys):
    """The port warms up for at least JAX's 80 frames and until the IMU
    initializes (ROADMAP queue 3): on the plane alone that was frame 106;
    with bench.py's mesas in the scene, frame 78 on the CPU."""
    rc = drive_vi_chain_ablation.main(["--device", "cpu"])
    out = capsys.readouterr().out
    print(out)
    m = re.search(r"warm-up: (\d+) frames .* IMU initialized at frame (\d+)", out)
    warmup, imu_frame = int(m.group(1)), int(m.group(2))
    assert rc == 0 and warmup >= drive_vi_chain_ablation.MIN_WARMUP and imu_frame < warmup
