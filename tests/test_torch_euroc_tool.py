"""The port's sequence runner (`orbslam3_tpu_torch.tools.run_euroc`) end to
end on the CPU, on the generated EuRoC-layout tree of
`tests/test_euroc_tool.py` (its fixture, 60 frames at 480x752 with cam1,
depth0, a 200 Hz IMU and the ground truth), under that file's gates:
processed N frames, 0 resets, more than 60% of the frames in the TUM file,
an ATE below 0.15 of the path's span and, for the metric arms, |scale - 1|
below 0.1.  Both tools' mono arms run on the same tree; whole runs draw
different RANSAC samples, so their poses are not compared, but the port's
ATE must stay within 2x of the JAX tool's.  Slow, as the JAX tool's tests
are.

The TUM-VI arm (`--dataset tumvi --mode stereo-inertial`) on the TUM-VI-layout
tree of `utils/tumvi_scene.py` (raw KB8 fisheye pairs at 512x512, a 200 Hz
body-frame IMU): the tree's IMU against its path, both tools on a short
tree, and the whole 60-frame arm under the gates above (slow).  Also a kept
gap of the reference: `--dataset tumvi --mode stereo` runs EuRoC's preset.
"""

import os
import sys

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch import config as tpresets
from orbslam3_tpu_torch.io import euroc as teuroc
from orbslam3_tpu_torch.pipeline import stereo_system as tss
from orbslam3_tpu_torch.tools import run_euroc
from orbslam3_tpu_torch.utils import euroc_scene as es
from orbslam3_tpu_torch.utils import tumvi_scene as ts
from test_euroc_tool import FPS, N_FRAMES, cam_center, euroc_tree  # noqa: F401

torch.set_num_threads(4)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
TUMVI_SHORT = 8           # frames of the short TUM-VI tree
TUMVI_ARGS = ["--dataset", "tumvi", "--mode", "stereo-inertial", "--features", "1000"]

SPAN = float(np.linalg.norm(cam_center(N_FRAMES / FPS) - cam_center(0.0)))


def _run(argv, capsys):
    res = run_euroc.main(argv + ["--device", "cpu"])
    return res, capsys.readouterr().out


def _check(out, traj, metric):
    assert f"processed {N_FRAMES} frames" in out, out
    assert "resets=0" in out, out
    lines = [ln for ln in open(traj).read().splitlines() if ln]
    assert len(lines) > 0.6 * N_FRAMES, len(lines)
    assert len(lines[0].split()) == 8
    assert "ATE: rmse=" in out, out
    rmse = float(out.split("ATE: rmse=")[1].split()[0])
    assert np.isfinite(rmse) and rmse < 0.15 * SPAN, (rmse, SPAN)
    if metric:
        scale = float(out.split("scale=")[1].split()[0])
        assert abs(scale - 1.0) < 0.1, scale
    return rmse


@pytest.mark.slow
@pytest.mark.parametrize("mode,metric", [("mono", False), ("stereo", True),
                                         ("stereo-inertial", True), ("rgbd", True),
                                         ("mono-inertial", False)])
def test_port_tool_arm(euroc_tree, capsys, tmp_path, mode, metric):  # noqa: F811
    traj = str(tmp_path / "traj.txt")
    res, out = _run([euroc_tree, "--mode", mode, "--out", traj, "--features", "1200"], capsys)
    _check(out, traj, metric)
    assert res["decoder"] == "native" and out.splitlines()[0] == "ingest: native"


@pytest.mark.slow
def test_both_tools_mono_on_one_tree(euroc_tree, capsys, tmp_path):  # noqa: F811
    sys.path.insert(0, TOOLS)
    import run_euroc as jax_run_euroc
    jtraj, ttraj = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    old = sys.argv
    sys.argv = ["run_euroc.py", euroc_tree, "--mode", "mono", "--out", jtraj]
    try:
        jax_run_euroc.main()
    finally:
        sys.argv = old
    j_rmse = _check(capsys.readouterr().out, jtraj, False)
    _, out = _run([euroc_tree, "--mode", "mono", "--out", ttraj], capsys)
    t_rmse = _check(out, ttraj, False)
    print(f"mono ATE: JAX tool {j_rmse}, port {t_rmse}")
    assert t_rmse <= 2.0 * j_rmse, (t_rmse, j_rmse)


@pytest.mark.slow
def test_port_scene_writes_the_fixtures_tree(euroc_tree, tmp_path):  # noqa: F811
    """`utils/euroc_scene.write_tree` (the smoke's copy of the fixture)
    writes the fixture's files byte for byte."""
    root = es.write_tree(str(tmp_path / "port"), N_FRAMES)
    names = []
    for d, _, files in os.walk(euroc_tree):
        names += [os.path.relpath(os.path.join(d, f), euroc_tree) for f in files]
    assert len(names) == 3 * N_FRAMES + 5
    for rel in names:
        with open(os.path.join(euroc_tree, rel), "rb") as a, \
                open(os.path.join(root, rel), "rb") as b:
            assert a.read() == b.read(), rel


# ------------------------------------------------------------------ TUM-VI
@pytest.fixture(scope="module")
def tumvi_short(tmp_path_factory):
    return ts.write_tree(str(tmp_path_factory.mktemp("tumvi") / "seq"), TUMVI_SHORT)


def _jax_tool(argv, capsys):
    """JAX's tools/run_euroc.py `main` on `argv`; its standard output."""
    sys.path.insert(0, TOOLS)
    import run_euroc as jax_run_euroc
    old = sys.argv
    sys.argv = ["run_euroc.py"] + argv
    try:
        jax_run_euroc.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_tumvi_tree_imu_integrates_to_its_ground_truth(tumvi_short):
    """The tree's 200 Hz IMU is the path's, in the body frame: each sample
    rotated into the world by R_wb (TUMVI_IMU's Tbc: body <- cam0, whose
    attitude is the world's) plus gravity, integrated twice (exact for
    an acceleration linear between samples) from the first ground-truth
    position and the velocity that reaches the second, lands on every
    frame's ground-truth position within 1e-5 m (measured 6.6e-9); the gyro
    reads 0.  The same samples taken as the world's miss by more than 0.1 m
    (measured 0.52 m over the tree's 0.35 s)."""
    mav = os.path.join(tumvi_short, "mav0")
    imu = np.loadtxt(os.path.join(mav, "imu0", "data.csv"), delimiter=",", skiprows=1)
    gt = np.loadtxt(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
                    delimiter=",", skiprows=1)
    t, gt_ts = imu[:, 0] * 1e-9, gt[:, 0] * 1e-9
    assert len(gt) == TUMVI_SHORT and np.all(imu[:, 1:4] == 0.0)
    assert t[0] == 0.0 and t[-1] >= gt_ts[-1] and np.allclose(np.diff(t), 1 / ts.IMU_HZ)

    def integrate(R_wb):
        a = imu[:, 4:] @ R_wb.T + ts.G_W
        dt = np.diff(t)
        dp = np.zeros((len(t), 3))       # displacement from rest at t = 0
        dv = np.zeros(3)
        for k in range(len(dt)):
            dp[k + 1] = dp[k] + dv * dt[k] + (a[k] / 3 + a[k + 1] / 6) * dt[k] ** 2
            dv = dv + 0.5 * (a[k] + a[k + 1]) * dt[k]
        at = [np.argmin(np.abs(t - x)) for x in gt_ts]
        v0 = (gt[1, 1:4] - gt[0, 1:4] - dp[at[1]]) / (t[at[1]] - t[0])
        return gt[0, 1:4] + v0 * t[at][:, None] + dp[at]

    R_bw = teuroc.TUMVI_IMU["Tbc"][:3, :3]
    np.testing.assert_allclose(integrate(R_bw.T), gt[:, 1:4], atol=1e-5, rtol=0)
    assert np.abs(integrate(np.eye(3)) - gt[:, 1:4]).max() > 0.1


def test_both_tools_tumvi_stereo_inertial_on_a_short_tree(tumvi_short, capsys, tmp_path):
    """JAX's and the port's runner, `--dataset tumvi --mode stereo-inertial
    --features 1000 --max-frames 4`, on one short TUM-VI tree on the CPU.
    The host decoder gives the same rectified frames bit for bit in both
    packages (each package's preset maps on each camera).  Both process 4
    frames, 0 resets, and write 4 TUM lines: timestamps equal, positions
    within 5e-4 and quaternions within 1e-4 of JAX's.  Measured: 1.82e-4
    and 2.0e-5 (`tests/acceptance_numbers.py floats`).  The gap is float
    rounding carried through the matching gates, not logic: on scenario J
    the port tracks within 8.1e-7 of JAX from JAX's state and 4.5e-5 apart
    from its own map, whose points lie within 4.3e-6 of JAX's (the same
    script)."""
    from orbslam3_tpu import config as jpresets
    from orbslam3_tpu.io import euroc as jeuroc
    *_, jm0, jm1 = jpresets.tumvi_stereo_inertial()
    *_, tm0, tm1 = tpresets.tumvi_stereo_inertial()
    for sub, jm, tm in (("cam0", jm0, tm0), ("cam1", jm1, tm1)):
        js, tsq = jeuroc.EurocSequence(tumvi_short, cam=sub), teuroc.EurocSequence(tumvi_short,
                                                                                   cam=sub)
        for a, b in list(zip(js.images, tsq.images))[:4]:
            np.testing.assert_array_equal(teuroc.apply_undistort(tsq.load_image(b), tm),
                                          jeuroc.apply_undistort(js.load_image(a), jm))
    jtraj, ttraj = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    out = _jax_tool([tumvi_short, *TUMVI_ARGS, "--max-frames", "4", "--out", jtraj], capsys)
    assert "processed 4 frames" in out and "resets=0" in out, out
    res = run_euroc.main([tumvi_short, *TUMVI_ARGS, "--max-frames", "4", "--out", ttraj,
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "processed 4 frames" in out and "resets=0" in out, out
    assert res["system"].n_resets == 0
    j, t = np.loadtxt(jtraj), np.loadtxt(ttraj)
    assert j.shape == t.shape == (4, 8)
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=5e-4, rtol=0)
    np.testing.assert_allclose(t[:, 4:], j[:, 4:], atol=1e-4, rtol=0)


def test_tumvi_stereo_runs_the_euroc_preset_in_both_tools(tumvi_short, capsys, monkeypatch):
    """A kept gap of the reference (ROADMAP queue 3): `--dataset tumvi
    --mode stereo` builds its StereoSystem from EuRoC's rectified preset
    and maps (JAX's tools/run_euroc.py:91-93), not TUM-VI's, and the port
    does the same: both tools' System gets EuRoC's 480x752 rectified
    pinhole and baseline (the run is stopped at the System's
    construction)."""
    from orbslam3_tpu.pipeline import stereo_system as jss
    seen = {}

    class Built(Exception):
        pass

    def spy(name):
        def build(cfg, scfg, *a, **k):
            seen[name] = (tuple(cfg.image_hw), tuple(float(v) for v in cfg.cam_params),
                          float(scfg.baseline))
            raise Built
        return build

    monkeypatch.setattr(jss, "StereoSystem", spy("jax"))
    monkeypatch.setattr(tss, "StereoSystem", spy("port"))
    argv = [tumvi_short, "--dataset", "tumvi", "--mode", "stereo"]
    with pytest.raises(Built):
        _jax_tool(argv, capsys)
    with pytest.raises(Built):
        run_euroc.main(argv + ["--device", "cpu"])
    cfg, scfg, *_ = tpresets.euroc_stereo_rectified()
    euroc = (tuple(cfg.image_hw), tuple(float(v) for v in cfg.cam_params), float(scfg.baseline))
    assert seen["jax"] == seen["port"] == euroc
    assert euroc[0] == tuple(teuroc.EUROC_CAM0["resolution"]) != \
        tuple(teuroc.TUMVI_CAM0["resolution"])


@pytest.mark.slow
def test_port_tool_tumvi_stereo_inertial_arm(tmp_path, capsys):
    """The whole TUM-VI stereo-inertial arm on the port's CPU: the
    60-frame tree (`tumvi_scene.write_tree`) through `run_euroc` at the
    preset's full width (512x512, 1000 features over 8 levels) under
    tests/test_euroc_tool.py's gates for a metric arm (processed 60 frames,
    0 resets, more than 36 TUM lines, ATE below 0.15 of the span, |scale -
    1| below 0.1)."""
    root = ts.write_tree(str(tmp_path / "seq"), ts.N_FRAMES)
    traj = str(tmp_path / "traj.txt")
    res = run_euroc.main([root, *TUMVI_ARGS, "--out", traj, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"processed {ts.N_FRAMES} frames" in out, out
    assert "resets=0" in out, out
    lines = [ln for ln in open(traj).read().splitlines() if ln]
    assert len(lines) > 0.6 * ts.N_FRAMES and len(lines[0].split()) == 8
    rmse = float(out.split("ATE: rmse=")[1].split()[0])
    scale = float(out.split("scale=")[1].split()[0])
    assert np.isfinite(rmse) and rmse < 0.15 * ts.span(), (rmse, ts.span())
    assert abs(scale - 1.0) < 0.1, scale
    print(f"TUM-VI arm: ATE {rmse}, scale {scale}, {res['system'].n_kf_host} keyframes, "
          f"IMU initialized {res['system'].imu_initialized}")
