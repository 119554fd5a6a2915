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
"""

import os
import sys

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.tools import run_euroc
from orbslam3_tpu_torch.utils import euroc_scene as es
from test_euroc_tool import FPS, N_FRAMES, cam_center, euroc_tree  # noqa: F401

torch.set_num_threads(4)

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
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
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
