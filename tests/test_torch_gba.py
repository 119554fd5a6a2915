"""The port's COO bundle adjuster, its window gathers and the post-loop
full-map GBA against the JAX package's.

`bundle_adjust` runs on `tests/test_solver.py`'s synthetic problem (made by
the JAX test's own code) in both Schur modes; the gathers and `gba` on a
JAX-built map with an observation list and a feature bank at a small
capacity (32 keyframes, 4096 points, 16384 observations).  Each test states
its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.features.extractor import FeatureFrame as JFeatureFrame
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.slam_map import feature_bank as jbank
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu.solver import ba as jba
from orbslam3_tpu_torch.pipeline import mapping as tmapping
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.solver import ba as tba
from test_solver import K_EUROC, make_ba_problem, synth_scene

torch.set_num_threads(2)

CAP = dict(n_kf=32, n_pt=4096, n_obs=16384)
K4 = (458.654, 457.296, 367.215, 248.375)


def _t(x):
    return torch.from_numpy(np.array(jax.device_get(x)))


def _tprob(prob) -> tba.BAProblem:
    return tba.BAProblem(**{k: None if getattr(prob, k) is None else _t(getattr(prob, k))
                            for k in prob._fields})


@pytest.fixture(scope="module")
def solver_problem():
    """test_solver.test_refines_noisy_points_and_poses's problem: 5 cameras,
    120 points, poses and points perturbed, 2 cameras fixed."""
    X, R, t, uv = synth_scene(jax.random.PRNGKey(3), n_pts=120, n_cams=5, noise_px=0.0)
    dxi = 0.01 * jax.random.normal(jax.random.PRNGKey(4), (5, 6))
    dxi = dxi.at[0].set(0.0).at[1].set(0.0)
    dR, dt = jlie.se3_exp(dxi)
    Rp, tp = jlie.se3_compose(dR, dt, R, t)
    return make_ba_problem(X, Rp, tp, uv, pt_noise=0.05, key=jax.random.PRNGKey(5))


def _run_both(prob, solver, iterations, **kw):
    ref = jax.jit(jba.bundle_adjust, static_argnames=(
        "cam_model", "iterations", "schur_solver", "pcg_iters", "stereo_bf"))(
        prob, "pinhole", K_EUROC, iterations=iterations, schur_solver=solver, pcg_iters=12, **kw)
    got = tba.bundle_adjust(_tprob(prob), "pinhole", _t(K_EUROC), iterations=iterations,
                            schur_solver=solver, pcg_iters=12, **kw)
    return got, ref


@pytest.mark.parametrize("solver,iterations,tol", [
    ("dense", 3, 1e-4), ("pcg", 3, 1e-4), ("dense", 8, 1e-3), ("pcg", 8, 1e-3)])
def test_bundle_adjust_matches_jax(solver_problem, solver, iterations, tol):
    """Poses and points within 1e-4 after 3 LM steps and 1e-3 after 8 (the
    PCG's float32 sums run in another order; the VI BA measured 0.85e-4
    after 3), the per-observation chi2 within 1e-3 relative of its scale."""
    got, ref = _run_both(solver_problem, solver, iterations)
    for name in ("R", "t", "X"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=tol, err_msg=name)
    chi2 = np.asarray(ref.obs_chi2)
    assert np.abs(got.obs_chi2.numpy() - chi2).max() < 1e-3 * max(chi2.max(), 1.0)
    assert float(got.cost) == pytest.approx(float(ref.cost), rel=1e-3, abs=1e-4)


@pytest.mark.parametrize("term", ["stereo", "priors"])
def test_stereo_rows_and_position_priors_match_jax(solver_problem, term):
    """The residual terms that the GNSS BA (position priors on the camera
    centres) and stereo maps (a third row ur - (u - bf / z)) add, which the
    port's System refuses for now: 3 PCG LM steps against JAX's, poses and
    points within 1e-4, the cost within 1e-3 relative or 1e-4."""
    p = solver_problem
    rng = np.random.default_rng(11)
    O, K = p.obs_uv.shape[0], p.R.shape[0]
    kw = {}
    if term == "stereo":
        ur = np.asarray(p.obs_uv[:, 0]) - 40.0 + rng.normal(0, 0.5, O)
        ur[rng.random(O) < 0.5] = -1.0                  # half the rows mono
        p = p._replace(obs_ur=jnp.asarray(ur, jnp.float32))
        kw = dict(stereo_bf=45.0)
    else:
        centres = -np.einsum("kji,kj->ki", np.asarray(p.R), np.asarray(p.t))
        p = p._replace(prior_pos=jnp.asarray(centres + rng.normal(0, 0.05, (K, 3)), jnp.float32),
                       prior_w=jnp.asarray([0, 0, 50.0, 0, 20.0], jnp.float32))
    got, ref = _run_both(p, "pcg", 3, **kw)
    for name in ("R", "t", "X"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4, err_msg=name)
    assert float(got.cost) == pytest.approx(float(ref.cost), rel=1e-3, abs=1e-4)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_fixed_cameras_stay_fixed_and_padding_is_inert(solver):
    """test_solver's two checks on the port, at its tolerances: fixed
    cameras come back within 1e-7 (every step re-orthonormalizes every
    rotation), and padded cameras, points and observations (garbage values,
    invalid) change nothing of the real ones (within 1e-6 / 1e-5)."""
    X, R, t, uv = synth_scene(jax.random.PRNGKey(8), n_pts=50, n_cams=3, noise_px=0.1)
    prob = _tprob(make_ba_problem(X, R, t, uv, pt_noise=0.02, key=jax.random.PRNGKey(9)))
    cam = _t(K_EUROC)
    res1 = tba.bundle_adjust(prob, "pinhole", cam, iterations=6, schur_solver=solver)
    np.testing.assert_allclose(res1.R[:2].numpy(), prob.R[:2].numpy(), atol=1e-7)
    np.testing.assert_allclose(res1.t[:2].numpy(), prob.t[:2].numpy(), atol=1e-7)
    padC, padP, padO = 2, 20, 40
    cat = lambda a, b: torch.cat([a, b])
    prob2 = tba.BAProblem(
        R=cat(prob.R, torch.eye(3).repeat(padC, 1, 1)), t=cat(prob.t, torch.full((padC, 3), 9.0)),
        cam_fixed=cat(prob.cam_fixed, torch.zeros(padC, dtype=torch.bool)),
        cam_valid=cat(prob.cam_valid, torch.zeros(padC, dtype=torch.bool)),
        X=cat(prob.X, torch.full((padP, 3), 77.0)),
        pt_valid=cat(prob.pt_valid, torch.zeros(padP, dtype=torch.bool)),
        obs_cam=cat(prob.obs_cam, torch.full((padO,), 3, dtype=prob.obs_cam.dtype)),
        obs_pt=cat(prob.obs_pt, torch.full((padO,), 55, dtype=prob.obs_pt.dtype)),
        obs_uv=cat(prob.obs_uv, torch.full((padO, 2), 1e4)),
        obs_inv_sigma2=cat(prob.obs_inv_sigma2, torch.ones(padO)),
        obs_valid=cat(prob.obs_valid, torch.zeros(padO, dtype=torch.bool)))
    res2 = tba.bundle_adjust(prob2, "pinhole", cam, iterations=6, schur_solver=solver)
    np.testing.assert_allclose(res1.t.numpy(), res2.t[:3].numpy(), atol=1e-6)
    np.testing.assert_allclose(res1.X.numpy(), res2.X[:50].numpy(), atol=1e-5)


def test_repeated_observations_accumulate_as_jax(solver_problem):
    """T14: every observation appears twice (and a third time for the first
    camera's), so each normal-equation scatter names its camera and point
    blocks several times in one call; `index_add_` accumulates them as
    JAX's `.at[].add` does (Hcc, bc, Hpp, bp within 1e-4 relative, the free
    cameras' blocks twice those of the single list, and the 3-step solve
    within 1e-4), where `x[idx] += v` would keep one."""
    p = solver_problem
    rep = np.concatenate([np.arange(p.obs_cam.shape[0])] * 2 + [np.arange(120)])
    prob = p._replace(obs_cam=p.obs_cam[rep], obs_pt=p.obs_pt[rep], obs_uv=p.obs_uv[rep],
                      obs_inv_sigma2=p.obs_inv_sigma2[rep], obs_valid=p.obs_valid[rep])
    ref = jba._build_normal_eq(prob, prob.R, prob.t, prob.X, "pinhole", K_EUROC, 5.991, True)
    tp = _tprob(prob)
    got = tba._build_normal_eq(tp, tp.R, tp.t, tp.X, "pinhole", _t(K_EUROC), 5.991, True)
    for name, g, r in zip(("Hcc", "bc", "Hpp", "bp"), got[:4], ref[:4]):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max(), name
    # the free cameras' blocks hold two copies of each of their terms
    single = tba._build_normal_eq(_tprob(p), tp.R, tp.t, tp.X, "pinhole", _t(K_EUROC), 5.991,
                                  True)
    assert torch.allclose(got[0][2:], 2 * single[0][2:], rtol=1e-5, atol=1e-3)
    g3, r3 = _run_both(prob, "pcg", 3)
    np.testing.assert_allclose(g3.X.numpy(), np.asarray(r3.X), atol=1e-4)


# --- a JAX-built map with observations and a bank -------------------------------------

N_KF, N_PT, N_KP = 8, 300, 320


def _jax_map(seed=0):
    """A JAX map and feature bank: N_PT points in front of N_KF keyframes
    along x, observed (0.5 px noise, octaves 0-3) wherever they project into
    the image; poses after keyframe 1 and every point perturbed, so that a
    BA has work.  The points are created with keyframe 0 and every
    keyframe's observations and bank bindings follow."""
    rng = np.random.default_rng(seed)
    cam = jnp.asarray(K4, jnp.float32)
    m = jstate.empty_map(jstate.MapCapacity(**CAP))
    bank = jbank.empty_bank(CAP["n_kf"], N_KP)
    X = np.stack([rng.uniform(-3, 4, N_PT), rng.uniform(-2, 2, N_PT),
                  rng.uniform(5, 9, N_PT)], 1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (N_PT, 8), dtype=np.uint32)
    Xn = X + rng.normal(0, 0.03, X.shape).astype(np.float32)
    pt = None
    for k in range(N_KF):
        R = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32)))
        t = np.array([-0.25 * k, 0.0, 0.0], np.float32)
        Xc = X @ R.T + t
        uv = np.asarray(jcam.pinhole_project(cam, jnp.asarray(Xc))) + \
            rng.normal(0, 0.5, (N_PT, 2)).astype(np.float32)
        vis = (Xc[:, 2] > 0) & (uv[:, 0] > 0) & (uv[:, 0] < 752) & (uv[:, 1] > 0) & \
            (uv[:, 1] < 480)
        if k >= 2:
            dR = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.005, 3), jnp.float32)))
            R, t = dR @ R, t + rng.normal(0, 0.02, 3).astype(np.float32)
        m, ki = jstate.add_keyframe(m, jnp.asarray(R), jnp.asarray(t), 0.1 * k, k)
        if pt is None:
            m, pt = jstate.add_points(m, jnp.asarray(Xn), jnp.asarray(desc),
                                      jnp.tile(jnp.asarray([0.0, 0, 1]), (N_PT, 1)),
                                      jnp.full(N_PT, 0.5), jnp.full(N_PT, 40.0), 0, 0,
                                      jnp.ones(N_PT, bool))
        octave = rng.integers(0, 4, N_PT).astype(np.int32)
        m = jstate.add_observations(m, ki, pt, jnp.asarray(uv), jnp.asarray(octave),
                                    jnp.asarray(vis))
        pad = N_KP - N_PT
        ff = JFeatureFrame(
            xy=jnp.asarray(np.concatenate([uv, np.zeros((pad, 2), np.float32)])),
            response=jnp.ones(N_KP), octave=jnp.asarray(np.concatenate(
                [octave, np.zeros(pad, np.int32)])), angle=jnp.zeros(N_KP),
            desc=jnp.asarray(np.concatenate([desc, np.zeros((pad, 8), np.uint32)])),
            valid=jnp.asarray(np.arange(N_KP) < N_PT))
        kp = np.full(N_KP, -1, np.int32)
        kp[:N_PT] = np.where(vis, np.asarray(pt), -1)
        bank = jbank.set_frame(bank, ki, ff, jnp.asarray(kp))
    return m, bank


@pytest.fixture(scope="module")
def jax_map():
    return _jax_map()


@pytest.mark.parametrize("source", ["observations", "bank"])
def test_temporal_window_gather_matches_jax(jax_map, source):
    """gather_window_problem (the map's observation list) and
    gather_window_problem_bank (the bank's rows) in temporal mode, the point,
    camera and observation caps binding: the same selections, anchors and
    rows as JAX's, element for element."""
    jm, jb = jax_map
    kw = dict(window=4, n_levels=8, scale_factor=1.2, cap_cams=6, cap_pts=200, cap_obs=900,
              window_mode="temporal")
    tm, tb = convert.map_from_numpy(H.fields(jm)), convert.bank_from_numpy(H.fields(jb))
    if source == "bank":
        ref = jmapping.gather_window_problem_bank(jm, jb, jnp.asarray(N_KF - 1), **kw)
        got = tmapping.gather_window_problem_bank(tm, tb, N_KF - 1, **kw)
    else:
        ref = jmapping.gather_window_problem(jm, jnp.asarray(N_KF - 1), **kw)
        got = tmapping.gather_window_problem(tm, N_KF - 1, **kw)
    for name, g, r in zip(("cam_sel", "cam_ok", "pt_sel", "pt_ok"), got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    for k in ref[0]._fields:
        r = getattr(ref[0], k)
        if r is not None:
            np.testing.assert_array_equal(getattr(got[0], k).numpy(), np.asarray(r), err_msg=k)
    assert int(got[0].obs_valid.sum()) == 900
    assert bool(got[0].cam_fixed.any()) and not bool(got[0].cam_fixed.all())


def test_gba_matches_jax(jax_map):
    """`System._gba` (the capacity-wide temporal window from the bank through
    the PCG solve, 8 LM steps of 12 PCG steps) on the JAX-built map: every
    keyframe pose within 1e-3 and every point within 1e-3 of the map's
    extent, keyframe 0 untouched, and the poses closer to the truth than
    before."""
    jm, jb = jax_map
    jcfg = jsystem.SlamConfig(cam_params=K4, map_capacity=jstate.MapCapacity(**CAP),
                              enable_relocalization=False)
    tcfg = tsystem.SlamConfig(cam_params=K4, map_capacity=MapCapacity(**CAP),
                              enable_relocalization=False)
    ref = jsystem.System(jcfg)._gba(jm, jnp.asarray(N_KF - 1, jnp.int32), jb)
    tm = convert.map_from_numpy(H.fields(jm))
    got = tsystem.gba(tcfg, torch.tensor(K4), tm, N_KF - 1,
                      convert.bank_from_numpy(H.fields(jb)))
    g, r = convert.to_numpy(got), H.fields(ref)
    for name in ("kf_R", "kf_t"):
        np.testing.assert_allclose(g[name][:N_KF], r[name][:N_KF], atol=1e-3, err_msg=name)
    scale = np.abs(r["pt_xyz"][:N_PT]).max()
    assert np.abs(g["pt_xyz"][:N_PT] - r["pt_xyz"][:N_PT]).max() < 1e-3 * scale
    assert torch.equal(got.kf_R[0], tm.kf_R[0]) and torch.equal(got.kf_t[0], tm.kf_t[0])
    moved = np.abs(g["pt_xyz"][:N_PT] - H.fields(jm)["pt_xyz"][:N_PT]).max()
    assert moved > 1e-3
