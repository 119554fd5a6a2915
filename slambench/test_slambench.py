"""The harness's own tests, on the CPU.

    python -m pytest slambench -q

They hold the pieces of the yardstick: the renderer against its numpy
original, the end-to-end arithmetic, the trace reading, the kernel's byte
count, the import check, the manifest's names, the reference against the
port's extraction, and one cell driven end to end at a small size.
"""

from __future__ import annotations

import copy
import json
import os
import re

import numpy as np
import pytest
import torch

from slambench import checks, kernels, optimum, reference, run, scene, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small(spec: dict, frames: int = 240, min_keyframes: int = 4) -> tuple[dict, dict]:
    """A cell at 240x376 with 900 features over 4 levels (the JAX suite's
    end-to-end size), its texture at half the texels a metre so that a
    pixel sees what it sees at full size, and the preset overrides that
    give it."""
    from orbslam3_tpu_torch.features.extractor import OrbParams
    s = copy.deepcopy(spec)
    num = s["config"]["preset_numbers"]
    num["image_hw"] = [240, 376]
    num["cam_params"] = [v / 2 for v in num["cam_params"]]
    num["orb"] = dict(num["orb"], n_features=900, n_levels=4)
    s["traffic"]["frames"] = frames
    s["traffic"]["texture"]["tex_scale"] /= 2
    s["traffic"]["warmup"]["min_keyframes"] = min_keyframes
    return s, dict(image_hw=(240, 376), cam_params=tuple(num["cam_params"]),
                   orb=OrbParams(n_features=900, n_levels=4))


def test_torch_renderer_matches_the_numpy_renderer():
    tex = scene.block_texture(torch.Generator().manual_seed(3), 256, 8).numpy()
    K4, hw = (120.0, 120.0, 47.0, 30.0), (60, 94)
    path = scene.Path({"x": {"v": 1.2}, "y": {"sin": [[0.2, 0.8, 0.0]]}, "height": {"c": 2.5},
                       "yaw": {"sin": [[0.3, 0.5, 0.0]]}, "tilt": {"sin": [[0.05, 1.3, 0.0]]}})
    poses = [path.pose_cw(t) for t in (0.0, 0.35, 1.7, 4.2)]
    got = scene.render_batch(torch.from_numpy(np.stack([p[0] for p in poses])),
                             torch.from_numpy(np.stack([p[1] for p in poses])),
                             scene.pinhole_rays(K4, hw), torch.from_numpy(tex), 80.0).numpy()
    for k, (R, t) in enumerate(poses):
        want = scene.render_plane_np(R, t, K4, hw, tex, 80.0)
        d = np.abs(got[k] - want)
        assert np.mean(d) < 1e-2 and np.mean(d < 0.05) > 0.995, (k, d.max())


def test_a_stall_moves_fps_and_the_tail():
    F = run.Frame
    tail = run.load_metric("frame_ms.p97")
    steady = [F(i, 0.05, True, i % 10 == 0, False) for i in range(400)]
    assert run.end_to_end(steady, 20.0) == {"fps": pytest.approx(20.0)}
    assert tail.read(dict(frames=steady)) == pytest.approx(50.0)
    stalled = steady[:380] + [F(380 + i, 0.5, True, False, False) for i in range(14)]
    got = run.end_to_end(stalled, 380 * 0.05 + 14 * 0.5)
    assert got["fps"] == pytest.approx(394 / 26.0)
    assert tail.read(dict(frames=stalled)) == pytest.approx(500.0)
    assert tail.read(dict(frames=[])) is None


def test_range_table_owns_what_launches_inside_a_range():
    ev = [
        {"cat": "user_annotation", "name": "extract", "ts": 100, "dur": 50},
        {"cat": "user_annotation", "name": "local_ba", "ts": 200, "dur": 100},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 5, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 140, "dur": 5, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 210, "dur": 5, "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 400, "dur": 5, "args": {"correlation": 4}},
        {"cat": "kernel", "name": "fast", "ts": 120, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "orb_describe", "ts": 160, "dur": 5, "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 220, "dur": 10, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "other", "ts": 410, "dur": 7, "args": {"correlation": 4}},
    ]
    rows, busy, n = trace.range_table({"traceEvents": ev}, ("extract", "local_ba"))
    assert rows["extract"] == [1, 0.05, 0.035, 2]
    assert rows["local_ba"] == [1, 0.1, 0.01, 0]
    assert busy == pytest.approx(0.052) and n == 3
    dev = trace.device_summary({"traceEvents": ev})
    assert dev["busy_s"] == pytest.approx(52e-6) and dev["launches"] == 3
    assert dev["orb_describe_s"] == [pytest.approx(5e-6)]
    assert max(dev["gaps"])[1] == "other"
    assert trace.short_name("void at::native::vectorized_elementwise_kernel<4, at::native::"
                            "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
                            "FillFunctor<float>, std::array<char*, 1ul>)") == \
        "vectorized_elementwise_kernel<4, FillFunctor<float>, std::array<char*, 1ul> >"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"


def test_orb_describe_bytes_at_the_kernel_table_frame():
    """PERF.md's kernel table: 4,050,364 bytes for the 1,200 keypoints of
    the seeded scene's first seed frame (atlas 2210x752)."""
    from orbslam3_tpu_torch.features import extractor
    from orbslam3_tpu_torch.ops import orient
    from orbslam3_tpu_torch.utils import seeded_scene

    cfg = seeded_scene.SceneConfig()
    img = torch.from_numpy(seeded_scene.render_frames(cfg)[cfg.seed_frames[0]])
    sel = extractor.select_keypoints(img, cfg.orb)
    angle = orient.ic_angle(sel.atlas, sel.xy_atlas.to(torch.int32)).numpy()
    xy, hw = kernels.atlas_coords(sel.xy.numpy(), sel.octave.numpy(), tuple(img.shape),
                                  cfg.orb.n_levels, cfg.orb.scale_factor)
    assert hw == tuple(sel.atlas.shape)
    assert kernels.orb_describe_bytes(xy, angle, hw) == 4_050_364


def test_import_check_compares_whole_top_level_names():
    assert checks.loaded_jax(["orbslam3_tpu_torch", "orbslam3_tpu_torch.ops.fast", "numpy"]) == []
    assert checks.loaded_jax(["orbslam3_tpu.ops", "orbslam3_tpu_torch"]) == ["orbslam3_tpu"]
    assert checks.loaded_jax(["jax._src.api", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert checks.loaded_jax(["jaxtyping", "flaxen"]) == []


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_manifest_names_units_and_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert "setup_s" in e2e and len(b["configs"]) >= 1
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "slambench", "traffic", w["traffic"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "slambench", "metrics", m["name"] + ".py"))
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in moved.get("workloads", cells), (m["name"], w)
    for w in cells:
        reported = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_reference_descriptors_agree_with_the_port_extraction():
    from orbslam3_tpu_torch.features import extractor
    from orbslam3_tpu_torch.features.extractor import OrbParams

    seq = scene.Sequence(run.load_cell("euroc_mono.flight")["traffic"] | {"frames": 1},
                         dict(cam_params=[229.327, 228.648, 183.6075, 124.1875],
                              image_hw=[240, 376]), 7, "cpu")
    p = OrbParams(n_features=900, n_levels=4)
    ff = extractor.extract(torch.from_numpy(seq.frames[0]), p)
    v = ff.valid.numpy()
    got = reference.check_extraction(seq.frames[0], ff.xy.numpy()[v], ff.octave.numpy()[v],
                                     ff.desc.numpy()[v], 4, 1.2)
    assert got["desc_wrong"] <= 0.005 and got["n"] > 500
    bad = ff.desc.numpy()[v].copy()
    bad[::7, 3] ^= 1 << 5
    wrong = reference.check_extraction(seq.frames[0], ff.xy.numpy()[v], ff.octave.numpy()[v],
                                       bad, 4, 1.2)
    assert wrong["desc_wrong"] >= 1 / 7 - 0.01


def test_reference_pose_optimum():
    rng = np.random.default_rng(0)
    K4 = (458.654, 457.296, 367.215, 248.375)
    X = rng.uniform([-2, -1.5, 2], [2, 1.5, 4], (300, 3))
    R = scene.Path({"x": {}, "y": {}, "height": {}, "yaw": {"c": 0.2},
                    "tilt": {"c": 0.05}}).pose64(0.0)[0].T
    t = np.array([0.1, -0.2, 0.3])
    uv = reference.project(K4, X @ R.T + t)
    octave = rng.integers(0, 8, 300)
    assert reference.check_pose(R, t, X, uv, octave, K4, 1.2)["gap_px"] < 1e-6
    noisy = uv + rng.normal(0, 1.0, uv.shape)
    R2, t2 = reference.pose_optimum(R, t, X, noisy, 1.2 ** (-2.0 * octave), K4)
    assert reference.check_pose(R2, t2, X, noisy, octave, K4, 1.2)["gap_px"] < 1e-6
    assert reference.check_pose(R2, t2 + 1e-3, X, noisy, octave, K4, 1.2)["gap_px"] > 0.05


def test_pose_schedule_reference_holds_the_ports_optimizer():
    """The port's pose-only optimization from a perturbed start against the
    float64 replica of its schedule: the same pose and inliers; a pose
    moved 2 mm fails."""
    from orbslam3_tpu_torch.solver import pose_opt

    rng = np.random.default_rng(3)
    K4 = (458.654, 457.296, 367.215, 248.375)
    X = rng.uniform([-2, -1.5, 2], [2, 1.5, 4], (300, 3))
    octave = rng.integers(0, 8, 300)
    uv = reference.project(K4, X) + rng.normal(0, 1.0, (300, 2)) * 1.2 ** octave[:, None]
    uv[::25] += 15.0                                  # outliers
    valid = rng.uniform(size=300) < 0.95
    R0 = optimum.exp_so3([0.004, -0.003, 0.002])
    t0 = np.array([0.01, -0.02, 0.015])
    res = pose_opt.pose_optimization(_f32(R0), _f32(t0), _f32(X), _f32(uv),
                                     _f32(1.2 ** (-2.0 * octave)), torch.from_numpy(valid),
                                     "pinhole", K4)
    call = dict(R0=R0, t0=t0, X=X, uv=uv, valid=valid, octave=octave, R=res.R.double().numpy(),
                t=res.t.double().numpy(), inliers=res.inliers.numpy())
    got = reference.check_pose_schedule(call, K4, 1.2)
    assert got["gap_px"] < 1e-3 and got["flips"] == 0 and got["n"] > 250, got
    moved = dict(call, t=call["t"] + 2e-3)
    assert reference.check_pose_schedule(moved, K4, 1.2)["gap_px"] > 0.2


def test_trajectory_reference_recovers_a_similarity():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(50, 3))
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R *= np.sign(np.linalg.det(R))
    est = (gt - 0.3) @ R / 2.5
    gt_R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(50)])
    gt_R *= np.sign(np.linalg.det(gt_R))[:, None, None]
    got = reference.check_trajectory(est, gt, np.einsum("ji,njk->nik", R, gt_R), gt_R)
    assert got["ate_share"] < 1e-9 and got["scale"] == pytest.approx(2.5)
    s, Ro, t = got["align"]
    assert s == pytest.approx(2.5) and np.allclose(Ro, R) and np.allclose(s * est @ Ro.T + t, gt)


# ------------------------------------------- the optimizers' references
def _f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _imu_world():
    """The inertial cell's pass, its IMU samples from the seed, and the
    port's preintegration of an interval of them."""
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.pipeline import inertial_system

    spec = run.load_cell("euroc_mono_inertial.flight")
    imu = spec["config"]["preset_numbers"]["imu"]
    Tbc = np.asarray(imu["Tbc"], np.float64).reshape(4, 4)
    path = scene.Path(spec["traffic"]["path"])
    per = scene.imu_samples(path, Tbc, 200.0, 20.0, 60, imu, np.random.default_rng(0))
    samples = [s for p in per for s in p]
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    calib = imu_ops.ImuCalib.create(imu["noise_gyro"], imu["noise_acc"], imu["walk_gyro"],
                                    imu["walk_acc"], imu["imu_freq"])

    def body(t):
        Rwc, pwc = path.pose64(t)
        return Rwc @ Rbc.T, pwc - Rwc @ Rbc.T @ tbc

    def vel(t, h=1e-4):
        return (body(t + h)[1] - body(t - h)[1]) / (2 * h)

    def port_pre(t0, t1):
        take = [s for s in samples if t0 < s[0] <= t1]
        a, g, d = inertial_system.reference_imu_steps(take, t0, t1, None)
        return imu_ops.preintegrate(_f32(a), _f32(g), _f32(d), torch.ones(len(d), dtype=torch.bool),
                                    calib, torch.zeros(6), n_valid=len(d))
    return dict(imu=imu, Tbc=Tbc, samples=samples, body=body, vel=vel, port_pre=port_pre,
                K4=spec["config"]["preset_numbers"]["cam_params"])


@pytest.mark.parametrize("kind", ["lastkf", "lastframe"])
def test_vi_pose_reference_holds_the_ports_optimizer(kind):
    """The port's VI pose optimization on a frame of the inertial pass
    leaves ~nothing undone by the reference's measure; its input unchanged
    leaves all of it."""
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.solver import inertial, vi_pose_opt

    w = _imu_world()
    K4, Tbc, body, vel = w["K4"], w["Tbc"], w["body"], w["vel"]
    rng = np.random.default_rng(1)
    t1 = 2.0
    Rwb, pwb = body(t1)
    Rwc, pwc = Rwb @ Tbc[:3, :3], pwb + Rwb @ Tbc[:3, 3]
    uv0 = rng.uniform([20, 20], [730, 460], (300, 2))
    depth = rng.uniform(3, 6, 300)
    Xc = np.concatenate([(uv0 - K4[2:]) / K4[:2] * depth[:, None], depth[:, None]], 1)
    X = Xc @ Rwc.T + pwc
    octave = rng.integers(0, 4, 300)
    uv = uv0 + rng.normal(0, 1.0, (300, 2)) * 1.2 ** octave[:, None]
    start = (Rwb @ optimum.exp_so3([0.01, -0.01, 0.005]), pwb + [0.03, -0.02, 0.01],
             vel(t1) + [0.05, 0.0, -0.05], np.zeros(6))
    Rcb = Tbc[:3, :3].T
    vis = (_f32(X), _f32(uv), _f32(1.2 ** (-2.0 * octave)), torch.ones(300, dtype=torch.bool),
           "pinhole", K4, _f32(Rcb), _f32(-Rcb @ Tbc[:3, 3]), imu_ops.gravity("cpu"))
    call = dict(kind=kind, t1=t1, bias0=np.zeros(6), R0=start[0], p0=start[1], v0=start[2],
                b0=start[3])
    args = [_f32(a) for a in start]
    if kind == "lastkf":
        t0 = 1.5
        kf = (*body(t0), vel(t0), np.zeros(6))
        res = vi_pose_opt.vi_pose_optimization(
            *args, *(_f32(a) for a in kf),
            inertial.factor_from_preint(w["port_pre"](t0, t1)), *vis)
        call.update(kf=kf)
    else:
        t0 = 1.95
        H = np.diag([1e4] * 6 + [1e3] * 3 + [1e5] * 6)
        prior = (*body(t0), vel(t0), np.zeros(6))
        res, _ = vi_pose_opt.vi_pose_optimization_last_frame(
            *args, vi_pose_opt.VIPosePrior(*(_f32(a) for a in prior), H=_f32(H)),
            inertial.factor_from_preint(w["port_pre"](t0, t1)), *vis)
        call.update(prior=dict(R=prior[0], p=prior[1], v=prior[2], b=prior[3], H=H))
    inl = res.inliers.numpy()
    call.update(t0=t0, X=X[inl], uv=uv[inl], octave=octave[inl],
                out=dict(R=res.Rwb.double().numpy(), p=res.pwb.double().numpy(),
                         v=res.vel.double().numpy(), b=res.bias.double().numpy()))
    sel = [s for s in w["samples"] if t0 < s[0] <= t1]
    got = optimum.check_vi_pose(call, sel, w["imu"], K4, Tbc, 1.2)
    assert got["undone"] < 1e-6 and got["gap_px"] < 1e-2 and got["n"] > 250, got
    unchanged = dict(call, out=dict(R=start[0], p=start[1], v=start[2], b=start[3]))
    assert optimum.check_vi_pose(unchanged, sel, w["imu"], K4, Tbc, 1.2)["undone"] == \
        pytest.approx(1.0)


def test_imu_init_reference_holds_the_ports_initialization():
    """The port's inertial-only initialization over eight keyframes of the
    inertial pass, their positions at half scale: ~nothing undone; its
    start (no velocity, no bias, gravity along -z, scale 1) all of it."""
    from orbslam3_tpu_torch.solver import inertial

    w = _imu_world()
    kts = [0.25 + 0.3 * k for k in range(8)]
    f = inertial.stack_preints_device([w["port_pre"](a, b) for a, b in zip(kts[:-1], kts[1:])],
                                      list(range(7)), list(range(1, 8)))
    Rs = np.stack([w["body"](t)[0] for t in kts])
    ps = np.stack([w["body"](t)[1] for t in kts]) * 0.5
    res = inertial.inertial_only_init(f, _f32(Rs), _f32(ps), torch.ones(8, dtype=torch.bool),
                                      prior_g=1e2, prior_a=1e6, iterations=60)
    call = dict(Rwb=Rs, pwb=ps, pairs=[(i, i + 1) for i in range(7)],
                times=list(zip(kts[:-1], kts[1:])), b0=np.zeros((7, 6)), prior_g=1e2,
                prior_a=1e6, fix_scale=False,
                out=dict(scale=float(res.scale), Rwg=res.Rwg.double().numpy(),
                         bias=res.bias.double().numpy(), vel=res.vel.double().numpy()))
    got = optimum.check_imu_init(call, w["samples"], w["imu"])
    assert got["undone"] < 1e-4 and got["scale_gap"] < 5e-3 and got["vel_gap"] < 5e-3, got
    start = dict(scale=1.0, Rwg=np.eye(3), bias=np.zeros(6), vel=np.zeros((8, 3)))
    bad = optimum.check_imu_init(dict(call, out=start), w["samples"], w["imu"])
    assert bad["undone"] == pytest.approx(1.0) and bad["scale_gap"] > 0.4


def test_window_ba_reference_holds_the_ports_grid_ba():
    """The port's grid BA on a well-posed window of five cameras, one
    fixed: ~nothing undone; its input unchanged: all of it."""
    from orbslam3_tpu_torch.solver import ba_grid

    rng = np.random.default_rng(5)
    K4 = (458.654, 457.296, 367.215, 248.375)
    Kc, P = 5, 200
    Rs = np.stack([optimum.exp_so3(rng.normal(0, 0.05, 3)) for _ in range(Kc)])
    ts = -np.einsum("kab,kb->ka", Rs, np.stack([[0.3 * k, 0.02 * k, 0.0] for k in range(Kc)]))
    X = rng.uniform([-1.5, -1, 3], [2.5, 1, 5], (P, 3))
    uv = optimum.project(K4, np.einsum("kab,pb->pka", Rs, X) + ts[None])
    uv = uv + rng.normal(0, 1.0, uv.shape)
    valid = rng.uniform(size=(P, Kc)) < 0.8
    valid[:, :2] = True

    def pad(a, fill=0):
        return np.concatenate([a, np.full((a.shape[0], 16 - Kc) + a.shape[2:], fill, a.dtype)], 1)
    R0 = np.stack([optimum.exp_so3(rng.normal(0, 0.003, 3)) @ R for R in Rs])
    t0 = ts + rng.normal(0, 0.01, ts.shape)
    R0[0], t0[0] = Rs[0], ts[0]
    fixed = np.arange(16) == 0
    prob = ba_grid.GridBAProblem(
        R=_f32(pad(R0[None])[0]), t=_f32(pad(t0[None])[0]), cam_fixed=torch.from_numpy(fixed),
        cam_valid=torch.arange(16) < Kc, X=_f32(X + rng.normal(0, 0.02, X.shape)),
        pt_valid=torch.ones(P, dtype=torch.bool), uv=_f32(pad(uv)),
        inv_sigma2=_f32(pad(1.2 ** (-2.0 * rng.integers(0, 3, (P, Kc))), 1.0)),
        valid=torch.from_numpy(pad(valid, False)), ur=-torch.ones(P, 16))
    R, t, Xo, _ = ba_grid.bundle_adjust_grid(prob, "pinhole", K4, iterations=6)
    call = dict(R=prob.R.numpy(), t=prob.t.numpy(), X=prob.X.numpy(), fixed=fixed,
                cam_valid=prob.cam_valid.numpy(), pt_valid=prob.pt_valid.numpy(),
                uv=prob.uv.numpy(), inv_s2=prob.inv_sigma2.numpy(), valid=prob.valid.numpy(),
                out=dict(R=R.numpy(), t=t.numpy(), X=Xo.numpy()))
    got = optimum.check_ba(call, K4, 1.2)
    assert got["undone"] < 1e-3 and got["n_obs"] > 800, got
    unchanged = dict(call, out=dict(R=call["R"], t=call["t"], X=call["X"]))
    assert optimum.check_ba(unchanged, K4, 1.2)["undone"] == pytest.approx(1.0)


def test_the_flight_cell_at_a_small_size_on_the_cpu():
    spec, ov = small(run.load_cell("euroc_mono.flight"))
    out = run.run_cell(spec, 2 ** 31 + 12345, 6.0, False, device="cpu", overrides=ov)
    # at this size the port's window BA can reject every step of its
    # schedule and return its input (PERF.md, Open questions), which
    # `ba_undone` reads as 1: the run holds every other number and reads
    # that one
    assert all(out["checks"][k]["value"] <= out["checks"][k]["limit"]
               for k in ("desc_wrong", "pose_gap_px")), out["checks"]
    assert out["checks"]["ba_undone"]["value"] is not None
    assert out["failed"] == 0 and out["attempted"] >= 5
    assert set(out["metrics"]) == {"fps", "setup_s"}
    assert list(out)[-1] == "checks"
