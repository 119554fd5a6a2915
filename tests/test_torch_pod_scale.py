"""The port's pod-scale drive (`orbslam3_tpu_torch/tools/drives/drive_pod_scale.py`)
against the JAX drive (loaded by file path, as `test_torch_drives.py` loads
the others): `CircuitWorld`'s frames bit-equal to the JAX world's, `main` at
a cut `DRIVE_FRAMES` printing the JAX lines at the drive's full capacity
(1024 keyframes, 98,304 points, 786,432 observations; slow: ~37 s at 24
frames on 2 threads, most of it the keyframe steps at that capacity), and
the refusal of a card that is not there.  The whole 6,600-frame drive runs on the card only
(PERF.md)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.tools.drives import drive_pod_scale as pod

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_drive():
    spec = importlib.util.spec_from_file_location(
        "jax_drive_pod_scale", os.path.join(REPO, "tools", "drives", "drive_pod_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_circuit_world_frames_bit_equal_to_the_jax_drive():
    from orbslam3_tpu_torch.utils import synth_render as sr

    jd = _jax_drive()
    lap = int(6600 / 1.1)
    r = 0.05 * lap / (2 * np.pi)
    wj, wt = jd.CircuitWorld(r), pod.CircuitWorld(r)
    np.testing.assert_array_equal(wt.X, wj.X)
    np.testing.assert_array_equal(wt.desc, wj.desc)
    for i in (0, 1, 2, 500, 3000):
        phi = 2 * np.pi * i / lap
        R, t = sr.look_down_pose(r * np.cos(phi), r * np.sin(phi), 5.0, yaw=phi)
        fj, ft = wj.frame(R, t), wt.frame(R, t)
        np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
        np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32), np.asarray(fj.desc))
        np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
        assert int(ft.valid.sum()) > 100


LINES = ("world:", "frames OK: ", "keyframes: ", "(capacity 1024)", "loops closed: 0",
         "loop closures (frame, keyframes): none", "tracked frame median", "GBA absorb",
         "ATE (scale-aligned)", "wall:")


def _cut(frames, monkeypatch, capsys):
    monkeypatch.setenv("DRIVE_FRAMES", str(frames))
    rc = pod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in LINES:
        assert line in out, line
    assert "peak device memory" not in out            # on the CPU
    return rc, out.splitlines()


@pytest.mark.slow
def test_drive_at_a_cut_size_prints_the_jax_lines(capsys, monkeypatch):
    """24 frames (a lap of 21, so 17 degrees of heading per frame; at 12
    the map never initializes): the map initializes and takes keyframes at
    the full capacity, and the frames before the initialization are more
    than a tenth of 24, so the drive's own gate (over 90% of frames OK) says
    FAIL."""
    rc, lines = _cut(24, monkeypatch, capsys)
    ok, n = (int(x) for x in lines[lines.index("") + 1].split()[2].split("/"))
    assert n == 24 and 0 < ok <= 0.9 * n and "resets: 0" in lines[lines.index("") + 1]
    assert lines[-1] == "DRIVE FAIL" and rc == 1


@pytest.mark.slow
def test_drive_at_60_frames_passes_its_gate(capsys, monkeypatch):
    rc, lines = _cut(60, monkeypatch, capsys)
    assert lines[-1] == "DRIVE PASS" and rc == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_drive_refuses_the_card_without_one():
    with pytest.raises(SystemExit):
        pod.main([])
