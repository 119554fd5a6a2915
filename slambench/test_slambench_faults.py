"""`correct` has to come out false on a broken timed path and on the control.

    python -m pytest slambench/test_slambench_faults.py -q            # the CPU faults
    python -m pytest slambench/test_slambench_faults.py -q -m gpu     # the rest, on a card

The CPU faults run the flight cell at a small size, the harness's look for a
card skipped, with the program broken underneath the harness once set-up is
over: a tracking step that returns its state unchanged, a descriptor altered
where the extraction produces it, a pose altered where the pose optimizer
produces it.  Each has to fail the number that watches that layer.  On a
card, at the cells' own size: the window BA returning its input unchanged
(flight), the VI pose optimizations returning their input unchanged and the
inertial-only initialization returning its start (inertial), and the control
in each cell, the program with TF32 matmuls, the precision below the
configuration's float32 with TF32 off.  A cell has no batch to halve and no
exchange between chips.
"""

from __future__ import annotations

import pytest
import torch

from slambench import run
from slambench.test_slambench import small


def _after_warm_up(monkeypatch, fault):
    """Run `fault()` (which installs the break) once set-up is over."""
    warm_up = run.warm_up

    def then_break(*args, **kwargs):
        out = warm_up(*args, **kwargs)
        fault()
        return out
    monkeypatch.setattr(run, "warm_up", then_break)


def _state_unchanged(monkeypatch):
    from orbslam3_tpu_torch.pipeline import system
    _after_warm_up(monkeypatch, lambda: monkeypatch.setattr(
        system.System, "_track_frame", lambda self, ff, ts: None))
    return "ate_share"


def _descriptor_altered(monkeypatch):
    from orbslam3_tpu_torch.features import extractor
    extract = extractor.extract
    on = []

    def altered(*args, **kwargs):
        ff = extract(*args, **kwargs)
        if not on:
            return ff
        desc = ff.desc.clone()
        desc[::5, 2] ^= 1 << 9
        return ff._replace(desc=desc)
    monkeypatch.setattr(extractor, "extract", altered)
    _after_warm_up(monkeypatch, lambda: on.append(True))
    return "desc_wrong"


def _pose_altered(monkeypatch):
    from orbslam3_tpu_torch.solver import pose_opt
    optimize = pose_opt.pose_optimization
    on = []

    def altered(*args, **kwargs):
        res = optimize(*args, **kwargs)
        return res._replace(t=res.t + 2e-3) if on else res
    monkeypatch.setattr(pose_opt, "pose_optimization", altered)
    _after_warm_up(monkeypatch, lambda: on.append(True))
    return "pose_gap_px"


def _fails(out, name) -> bool:
    c = out["checks"][name]
    return c["value"] is None or not c["value"] <= c["limit"]


@pytest.mark.parametrize("fault", [_state_unchanged, _descriptor_altered, _pose_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    spec, ov = small(run.load_cell("euroc_mono.flight"))
    watched = fault(monkeypatch)
    out = run.run_cell(spec, 2 ** 31 + 777, 5.0, False, device="cpu", overrides=ov)
    assert not out["correct"] and _fails(out, watched), out["checks"]


# ------------------------------------------------------------- on a card
def _ba_unchanged(monkeypatch):
    from orbslam3_tpu_torch.solver import ba_grid
    ba = ba_grid.bundle_adjust_grid
    on = []

    def unchanged(prob, *args, **kwargs):
        out = ba(prob, *args, **kwargs)
        return (prob.R, prob.t, prob.X, out[3]) if on else out
    monkeypatch.setattr(ba_grid, "bundle_adjust_grid", unchanged)
    _after_warm_up(monkeypatch, lambda: on.append(True))
    return "ba_undone"


def _vi_pose_unchanged(monkeypatch):
    from orbslam3_tpu_torch.solver import vi_pose_opt
    last_kf = vi_pose_opt.vi_pose_optimization
    last_frame = vi_pose_opt.vi_pose_optimization_last_frame
    on = []

    def kf(R0, p0, v0, b0, *args, **kwargs):
        res = last_kf(R0, p0, v0, b0, *args, **kwargs)
        return res._replace(Rwb=R0, pwb=p0, vel=v0, bias=b0) if on else res

    def frame(R0, p0, v0, b0, *args, **kwargs):
        res, prior = last_frame(R0, p0, v0, b0, *args, **kwargs)
        return (res._replace(Rwb=R0, pwb=p0, vel=v0, bias=b0), prior) if on else (res, prior)
    monkeypatch.setattr(vi_pose_opt, "vi_pose_optimization", kf)
    monkeypatch.setattr(vi_pose_opt, "vi_pose_optimization_last_frame", frame)
    _after_warm_up(monkeypatch, lambda: on.append(True))
    return "vi_undone"


def _imu_init_start(monkeypatch):
    """The inertial-only initialization returns its start: no velocity, no
    bias, gravity along -z, scale 1 (from the first call, in set-up)."""
    from orbslam3_tpu_torch.solver import inertial
    init = inertial.inertial_only_init

    def start(f, Rwb, *args, **kwargs):
        res = init(f, Rwb, *args, **kwargs)
        return res._replace(scale=torch.ones_like(res.scale), Rwg=torch.eye(3, device=Rwb.device),
                            bias=torch.zeros_like(res.bias), vel=torch.zeros_like(res.vel))
    monkeypatch.setattr(inertial, "inertial_only_init", start)
    return "init_undone"


def _on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("the cells' own size runs on a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault", [("euroc_mono.flight", _ba_unchanged),
                                        ("euroc_mono_inertial.flight", _vi_pose_unchanged),
                                        ("euroc_mono_inertial.flight", _imu_init_start)])
def test_a_solver_left_at_its_start_is_not_correct(monkeypatch, cell, fault):
    _on_a_card()
    watched = fault(monkeypatch)
    try:
        out = run.run_cell(run.load_cell(cell), 2 ** 31 + 5151, 4.0, False)
    except RuntimeError as e:
        # a run that cannot finish prints no result: it has failed
        assert "warm-up not met" in str(e) or "ran out of frames" in str(e), e
        return
    assert not out["correct"] and _fails(out, watched), out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["euroc_mono.flight", "euroc_mono_inertial.flight"])
def test_the_tf32_control_is_not_correct(cell):
    _on_a_card()
    out = run.run_cell(run.load_cell(cell), 2 ** 31 + 4242, 8.0, False, control="tf32")
    assert not out["correct"], out["checks"]
