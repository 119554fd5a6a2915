"""The port's inertial modules against the JAX package's: preintegration,
the inertial factors and the inertial-only initialization, the VI pose
optimizations, the COO window gather and the visual-inertial BA.

Every input is made with numpy from a seed (or by the JAX package's own
test scenes, `tests/test_inertial.py` and `tests/test_vi_ba.py`) and goes
through both sides; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import inertial_system as jis
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.slam_map import feature_bank as jbank
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu.solver import inertial as jinertial
from orbslam3_tpu.solver import vi_ba as jvi_ba
from orbslam3_tpu.solver import vi_pose_opt as jvpo
from orbslam3_tpu_torch.ops import imu as timu
from orbslam3_tpu_torch.ops import lie as tlie
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import mapping as tmapping
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.solver import inertial as tinertial
from orbslam3_tpu_torch.solver import vi_ba as tvi_ba
from orbslam3_tpu_torch.solver import vi_pose_opt as tvpo
from test_inertial import CALIB, TestReferenceImuSteps, make_factors, simulate
from test_vi_ba import K4 as VI_K4, build_vi_problem

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _jitted_scene_helpers():
    """test_inertial.simulate evaluates the JAX exp_so3 once per IMU sample
    and make_factors retraces the preintegration scan per factor; run both
    jitted while this module builds its scenes (the same functions, one
    dispatch per call)."""
    import types
    import test_inertial
    saved = test_inertial.lie, test_inertial.imu
    test_inertial.lie = types.SimpleNamespace(exp_so3=jax.jit(jlie.exp_so3))
    test_inertial.imu = types.SimpleNamespace(preintegrate=jax.jit(jimu.preintegrate))
    yield
    test_inertial.lie, test_inertial.imu = saved


TCALIB = timu.ImuCalib.create(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
G = np.array([0.0, 0.0, -9.81], np.float32)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(jax.device_get(x))) if dtype is None else \
        torch.from_numpy(np.array(jax.device_get(x), dtype))


def _np(x):
    return np.asarray(jax.device_get(x))


def _tfactor(f):
    return convert.factor_from_numpy(H.fields(f))


def _close(got, ref, rtol=0.0, atol=0.0, err=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               _np(ref), rtol=rtol, atol=atol, err_msg=err)


def _rel(got, ref):
    ref = _np(ref).astype(np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


# --- the step schedule and the packed rows ----------------------------------------

def _linear_samples(seed, t0, t1, n, with_next=True):
    sig = TestReferenceImuSteps()._signal
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(t0 + 1e-3, t1, n))
    take = [(float(t), *sig(t)) for t in times]
    return take, ((float(t1 + 0.0137), *sig(t1 + 0.0137)) if with_next else None)


@pytest.mark.parametrize("case", ["nonuniform", "no_next", "one", "two", "none"])
def test_reference_imu_steps_and_pack_rows_match_jax(case):
    """The schedule (and the packed rows at 64) equal the JAX module's,
    exactly, on TestReferenceImuSteps's inputs and the degenerate counts;
    the linear signal integrates exactly as that test asks (1e-4)."""
    t0, t1 = 0.1234, 0.8311
    if case == "nonuniform":
        take, nxt = _linear_samples(3, t0, t1, 9)
    elif case == "no_next":
        take, nxt = _linear_samples(4, t0, t1, 8, with_next=False)
    elif case == "one":
        take, nxt = _linear_samples(5, t0, t1, 1, with_next=False)
    elif case == "two":
        take, nxt = _linear_samples(6, t0, t1, 1)
    else:
        take, nxt = [], None
    ref = jis.reference_imu_steps(take, t0, t1, nxt)
    got = tis.reference_imu_steps(take, t0, t1, nxt)
    if ref is None:
        assert got is None
        return
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(tis.pack_imu_rows(got, 64), jis.pack_imu_rows(ref, 64))
    np.testing.assert_allclose(float(np.sum(got[2])), t1 - t0, rtol=1e-6)
    if case == "nonuniform":
        g_exact, a_exact = TestReferenceImuSteps()._exact(t0, t1)
        np.testing.assert_allclose(got[0].T @ got[2], a_exact, rtol=1e-4)
        np.testing.assert_allclose(got[1].T @ got[2], g_exact, rtol=1e-4)


def test_pack_rows_truncates_to_capacity():
    rng = np.random.default_rng(1)
    steps = (rng.normal(size=(100, 3)).astype(np.float32),
             rng.normal(size=(100, 3)).astype(np.float32), np.full(100, 0.005, np.float32))
    np.testing.assert_array_equal(tis.pack_imu_rows(steps, 64), jis.pack_imu_rows(steps, 64))
    assert tis._n_rows(tis.pack_imu_rows(steps, 64)) == 64


# --- preintegration -----------------------------------------------------------------

def _imu_rows(seed=0, n=120, pad=24):
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 1.5, (n, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    gyr = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    dt = rng.uniform(0.004, 0.006, n).astype(np.float32)
    accp = np.concatenate([acc, np.full((pad, 3), 123.0, np.float32)])
    gyrp = np.concatenate([gyr, np.full((pad, 3), -55.0, np.float32)])
    dtp = np.concatenate([dt, np.ones(pad, np.float32)])
    mask = np.arange(n + pad) < n
    bias = np.array([0.01, -0.02, 0.005, 0.1, -0.05, 0.2], np.float32)
    return accp, gyrp, dtp, mask, bias, n


@pytest.fixture(scope="module")
def preint():
    accp, gyrp, dtp, mask, bias, n = _imu_rows()
    ref = jimu.preintegrate(jnp.asarray(accp), jnp.asarray(gyrp), jnp.asarray(dtp),
                            jnp.asarray(mask), CALIB, jnp.asarray(bias))
    args = (torch.from_numpy(accp), torch.from_numpy(gyrp), torch.from_numpy(dtp),
            torch.from_numpy(mask), TCALIB, torch.from_numpy(bias))
    masked = timu.preintegrate(*args)
    trimmed = timu.preintegrate(*args, n_valid=n)
    return ref, masked, trimmed, bias


def test_calib_matches_jax():
    for k in ("sigma_g", "sigma_a", "sigma_gw", "sigma_aw"):
        assert float(getattr(TCALIB, k)) == float(getattr(CALIB, k)), k


def test_preintegrate_matches_jax_with_masked_padding(preint):
    """120 rows then 24 masked rows of garbage: every field within 1e-5
    (absolute; dT and the averages of ~1e1 within 1e-5 relative), C within
    1e-4 relative to its largest entry."""
    ref, got, _, _ = preint
    for k in got._fields:
        g, r = getattr(got, k).numpy(), _np(getattr(ref, k))
        if k == "C":
            assert _rel(g, r) < 1e-4, _rel(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(got.dT) == pytest.approx(float(ref.dT), rel=1e-6)


def test_trimmed_loop_equals_the_masked_loop_exactly(preint):
    """`n_valid` loops over the valid prefix only; the masked loop over every
    row gives bit-identical fields."""
    _, masked, trimmed, _ = preint
    for k in masked._fields:
        assert torch.equal(getattr(masked, k), getattr(trimmed, k)), k


def test_getters_and_predict_state_match_jax(preint):
    """The bias-corrected getters at a moved bias and the state prediction
    (PredictStateIMU) within 1e-5."""
    ref, got, bias, = preint[0], preint[2], preint[3]
    nb = bias + np.array([0.003, -0.002, 0.001, 0.02, 0.01, -0.03], np.float32)
    for name in ("delta_rotation", "delta_velocity", "delta_position"):
        _close(getattr(timu, name)(got, torch.from_numpy(nb)),
               getattr(jimu, name)(ref, jnp.asarray(nb)), atol=1e-5, err=name)
    R1 = jlie.exp_so3(jnp.array([0.2, -0.1, 0.3]))
    p1, v1 = jnp.array([1.0, 2.0, -0.5]), jnp.array([0.3, -0.2, 0.1])
    out_r = jimu.predict_state(R1, p1, v1, jnp.asarray(nb), ref)
    out_t = timu.predict_state(_t(R1), _t(p1), _t(v1), torch.from_numpy(nb), got)
    for g, r in zip(out_t, out_r):
        _close(g, r, rtol=1e-5, atol=1e-5)


# --- factors, residual, Jacobians ----------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """test_inertial.py's simulated trajectory, its factors on both sides."""
    Rs, ps, vs, accs, gyrs, dt = simulate(seed=1)
    f = make_factors(accs, gyrs, dt)
    preints = [timu.preintegrate(torch.from_numpy(a), torch.from_numpy(w),
                                 torch.full((a.shape[0],), dt), torch.ones(a.shape[0], dtype=torch.bool),
                                 TCALIB, n_valid=a.shape[0]) for a, w in zip(accs, gyrs)]
    ft = tinertial.stack_preints_device(preints, list(range(len(preints))),
                                        list(range(1, len(preints) + 1)))
    return Rs, ps, vs, f, ft


def test_factor_stacks_match_jax(scene):
    """The device stack from the port's own preintegrations against the JAX
    stack (1e-5, C 1e-4 relative), and the host `stack_preints` with
    padding rows."""
    _, _, _, f, ft = scene
    for k in ft._fields:
        g, r = getattr(ft, k).numpy(), _np(getattr(f, k))
        if k == "C":
            assert _rel(g, r) < 1e-4
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=k)
    pre = [timu.init_preintegrated()] * 2
    padded = tinertial.stack_preints(pre, [0, 1], [1, 2], capacity=5)
    assert padded.valid.tolist() == [True, True, False, False, False]
    assert padded.kf_j.tolist() == [1, 2, 0, 0, 0]


def _states(Rs, ps, vs, k):
    return (Rs[k], ps[k], vs[k], Rs[k + 1], ps[k + 1], vs[k + 1])


@pytest.mark.parametrize("where", ["zero_rotation", "generic"])
def test_inertial_residual_and_jacobian_match_jax(scene, where):
    """The 9-dof residual and its forward-mode Jacobian wrt the 15-dof
    update of the second state, at the linearization point where the
    residual's rotation is zero (T9: the double-where of log_so3; the
    clamp of cos_t sits on 1 there and its derivative, 1 in torch and
    0.5 in JAX, never reaches the result) and at a generic point: within
    1e-4 relative, finite."""
    Rs, ps, vs, f, ft = scene
    k = 2
    R1, p1, v1, R2, p2, v2 = _states(Rs, ps, vs, k)
    bias = np.zeros(6, np.float32)
    if where == "zero_rotation":
        # the second rotation that makes dR^T R1^T R2 the identity
        R2 = np.asarray(jnp.asarray(R1) @ f.dR[k])
    else:
        bias = np.array([0.01, -0.02, 0.01, 0.1, 0.05, -0.1], np.float32)

    def jres(d):
        Rj, pj, vj, _ = jvi_ba.apply_delta(jnp.asarray(R2), jnp.asarray(p2), jnp.asarray(v2),
                                           jnp.asarray(bias), d)
        return jinertial.inertial_residual(f, k, jnp.asarray(R1), jnp.asarray(p1),
                                           jnp.asarray(v1), Rj, pj, vj, jnp.asarray(bias),
                                           jnp.asarray(G))

    def tres(d):
        Rj, pj, vj, _ = tvi_ba.apply_delta(_t(R2), _t(p2), _t(v2), _t(bias), d)
        return tinertial.inertial_residual(ft, k, _t(R1), _t(p1), _t(v1), Rj, pj, vj,
                                           _t(bias), _t(G))

    z = np.zeros(15, np.float32)
    r_ref, J_ref = jax.jit(jres)(jnp.asarray(z)), jax.jit(jax.jacfwd(jres))(jnp.asarray(z))
    r_got, J_got = tres(_t(z)), tinertial.jacobian(tres, _t(z))
    assert J_got.dtype == torch.float32 and torch.isfinite(J_got).all()
    np.testing.assert_allclose(r_got.numpy(), _np(r_ref), atol=1e-4 * max(1.0, np.abs(_np(r_ref)).max()))
    assert _rel(J_got.numpy(), J_ref) < 1e-4, _rel(J_got.numpy(), J_ref)
    if where == "zero_rotation":
        assert np.abs(r_got.numpy()[:3]).max() < 1e-6


def test_log_so3_jacobian_at_identity_matches_jax():
    """jacfwd of log_so3 at the identity: finite and equal to JAX's (the
    clamp's derivative on its bound is cut off by the double where)."""
    eye = np.eye(3, dtype=np.float32)
    ref = jax.jit(jax.jacfwd(jlie.log_so3))(jnp.asarray(eye))
    got = tinertial.jacobian(tlie.log_so3, torch.from_numpy(eye))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-6)


def test_info_from_cov_matches_jax(scene):
    """The symmetrized inverse of the 9x9 covariance blocks, entries up to
    ~1e9: within 1e-3 of the largest entry of each block."""
    _, _, _, f, ft = scene
    ref = _np(jax.vmap(jinertial.info_from_cov)(f.C[:, :9, :9]))
    got = tinertial.info_from_cov(ft.C[:, :9, :9]).numpy()
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-3, _rel(g, r)
    assert np.abs(ref).max() > 1e6


# --- the inertial-only initialization ------------------------------------------------

@pytest.fixture(scope="module")
def init_pair(scene):
    """tests/test_inertial.py's scale / gravity scene through both
    `inertial_only_init`s (the JAX one on its own stack)."""
    Rs, ps, vs, f, ft = scene
    s_true, wg = 3.7, jnp.array([0.15, -0.1, 0.0])
    Rwg = jlie.exp_so3(wg)
    Rwb = jnp.einsum("ij,kjl->kil", Rwg.T, jnp.asarray(Rs))
    pwb = jnp.einsum("ij,kj->ki", Rwg.T, jnp.asarray(ps)) / s_true
    K = Rs.shape[0]
    ref = jinertial.inertial_only_init(f, Rwb, pwb, jnp.ones(K, bool), iterations=60)
    return Rwb, pwb, ft, ref


def _pad_factors(f, cap):
    """The stack padded to `cap` rows by repeating its first entry, masked by
    `valid`, as the JAX System's device stacker pads it."""
    F = f.dT.shape[0]
    pad = tinertial.PreintFactor(*(torch.cat([x, x[:1].expand((cap - F,) + x.shape[1:])])
                                   for x in f))
    return pad._replace(valid=torch.arange(cap) < F)


def _check_init(got, ref):
    assert abs(float(got.scale) - float(ref.scale)) / float(ref.scale) < 1e-3
    _close(got.Rwg, ref.Rwg, atol=1e-4)
    _close(got.bias, ref.bias, atol=1e-4)
    v = _np(ref.vel)
    assert np.max(np.abs(got.vel.numpy() - v)) < 1e-3 * np.abs(v).max()


@pytest.mark.parametrize("stack", ["unpadded", "padded"])
def test_inertial_only_init_matches_jax(init_pair, stack):
    """Scale within 1e-3 relative, Rwg within 1e-4, bias within 1e-4,
    velocities within 1e-3 of the largest; on the exact stack and on one
    padded to 16 rows as the JAX System pads it (the first entry repeated,
    masked by `valid`)."""
    Rwb, pwb, ft, ref = init_pair
    if stack == "padded":
        ft = _pad_factors(ft, 16)
    K = Rwb.shape[0]
    got = tinertial.inertial_only_init(ft, _t(Rwb), _t(pwb), torch.ones(K, dtype=torch.bool),
                                       iterations=60)
    _check_init(got, ref)
    assert abs(float(got.scale) - 3.7) / 3.7 < 0.05


def test_inertial_only_init_fixed_scale_recovers_bias():
    """test_inertial.py's gyro-bias case (fixed scale, prior_a 1e2) on both
    sides: bias within 1e-4 of JAX's, gyro bias within 5e-3 of the truth."""
    bias = np.array([0.02, -0.015, 0.01, 0.15, -0.1, 0.2], np.float32)
    Rs, ps, vs, accs, gyrs, dt = simulate(seed=2, bias=bias)
    f = make_factors(accs, gyrs, dt)
    K = Rs.shape[0]
    ref = jinertial.inertial_only_init(f, jnp.asarray(Rs), jnp.asarray(ps), jnp.ones(K, bool),
                                       iterations=80, prior_a=1e2, fix_scale=True)
    got = tinertial.inertial_only_init(_tfactor(f), _t(Rs), _t(ps), torch.ones(K, dtype=torch.bool),
                                       iterations=80, prior_a=1e2, fix_scale=True)
    _close(got.bias, ref.bias, atol=1e-4)
    assert float(got.scale) == 1.0
    np.testing.assert_allclose(got.bias[:3].numpy(), bias[:3], atol=5e-3)


# --- the VI pose optimizations -------------------------------------------------------

def _frame_scene(seed=1, n_pt=60):
    """Two body states under constant acceleration and 10 IMU samples, the
    current frame's observations of points at depth 4-6 (test_inertial_chain
    TestLastFramePrior's scene), a few outliers among them."""
    rng = np.random.default_rng(seed)
    dt, n = 0.05, 10
    g = np.asarray(jimu.GRAVITY)
    a_w = np.array([0.4, -0.2, 0.1])
    vp = np.array([0.3, 0.0, 0.1], np.float32)
    acc = np.tile((a_w - g).astype(np.float32), (n, 1))
    gyr = np.zeros((n, 3), np.float32)
    dts = np.full(n, dt / n, np.float32)
    pc = (vp * dt + 0.5 * a_w * dt * dt).astype(np.float32)
    vc = (vp + a_w * dt).astype(np.float32)
    X = rng.normal(0, 1.0, (n_pt, 3)).astype(np.float32)
    X[:, 2] = 4.0 + rng.uniform(0, 2, n_pt)
    X = X + pc
    Xc = X - pc
    uv = np.stack([VI_K4[0] * Xc[:, 0] / Xc[:, 2] + VI_K4[2],
                   VI_K4[1] * Xc[:, 1] / Xc[:, 2] + VI_K4[3]], 1).astype(np.float32)
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:4] += 40.0                       # outliers
    return dict(acc=acc, gyr=gyr, dts=dts, pc=pc, vc=vc, vp=vp, X=X, uv=uv,
                inv_s2=np.ones(n_pt, np.float32), valid=np.ones(n_pt, bool))


def _check_pose_result(got, ref, h_tol=1e-3):
    np.testing.assert_array_equal(got.inliers.numpy(), _np(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    for k in ("Rwb", "pwb", "vel", "bias"):
        _close(getattr(got, k), getattr(ref, k), atol=1e-4, err=k)
    assert _rel(got.H.numpy(), ref.H) < h_tol, _rel(got.H.numpy(), ref.H)


def test_vi_pose_optimization_last_keyframe_matches_jax():
    """PoseInertialOptimizationLastKeyFrame from a perturbed state: the same
    inliers (the outliers out), pose, velocity and bias within 1e-4, the
    final Hessian within 1e-3 relative."""
    s = _frame_scene()
    pre = jimu.preintegrate(jnp.asarray(s["acc"]), jnp.asarray(s["gyr"]), jnp.asarray(s["dts"]),
                            jnp.ones(10, bool), CALIB, jnp.zeros(6))
    f = jinertial.stack_preints([pre], [0], [1], capacity=1)
    eye, z3, z6 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.zeros(6, np.float32)
    args = (eye, s["pc"] + 0.05, s["vc"] + 0.1, z6, eye, z3, s["vp"], z6)
    vis = (s["X"], s["uv"], s["inv_s2"], s["valid"])
    ref = jax.jit(jvpo.vi_pose_optimization, static_argnums=(13,))(
        *map(jnp.asarray, args), f, *map(jnp.asarray, vis), "pinhole", VI_K4, jnp.eye(3),
        jnp.zeros(3), jimu.GRAVITY)
    got = tvpo.vi_pose_optimization(*map(_t, args), _tfactor(f), *map(_t, vis), "pinhole",
                                    _t(VI_K4), torch.eye(3), torch.zeros(3), _t(G))
    _check_pose_result(got, ref)
    assert int(got.n_inliers) == 56


def test_vi_pose_optimization_last_frame_matches_jax():
    """PoseInertialOptimizationLastFrame (test_inertial_chain's scene with
    outliers): the same inliers, the current state within 1e-4, the
    marginalized prior's H within 1e-3 relative; the prior is symmetric."""
    s = _frame_scene(seed=2)
    pre = jimu.preintegrate(jnp.asarray(s["acc"]), jnp.asarray(s["gyr"]), jnp.asarray(s["dts"]),
                            jnp.ones(10, bool), CALIB, jnp.zeros(6))
    f = jinertial.stack_preints([pre], [0], [1], capacity=1)
    eye, z3, z6 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.zeros(6, np.float32)
    prior = (eye, z3, s["vp"], z6, (np.eye(15) * 1e4).astype(np.float32))
    cur = (eye, s["pc"] + 0.05, s["vc"] + 0.1, z6)
    vis = (s["X"], s["uv"], s["inv_s2"], s["valid"])
    ref, ref_prior = jax.jit(jvpo.vi_pose_optimization_last_frame, static_argnums=(10,))(
        *map(jnp.asarray, cur), jvpo.VIPosePrior(*map(jnp.asarray, prior)), f,
        *map(jnp.asarray, vis), "pinhole", VI_K4, jnp.eye(3), jnp.zeros(3), jimu.GRAVITY)
    got, got_prior = tvpo.vi_pose_optimization_last_frame(
        *map(_t, cur), tvpo.VIPosePrior(*map(_t, prior)), _tfactor(f), *map(_t, vis),
        "pinhole", _t(VI_K4), torch.eye(3), torch.zeros(3), _t(G))
    _check_pose_result(got, ref)
    assert _rel(got_prior.H.numpy(), ref_prior.H) < 1e-3
    np.testing.assert_allclose(got_prior.H.numpy(), got_prior.H.numpy().T, rtol=0, atol=0)


# --- the COO window gather -----------------------------------------------------------

def _random_map(seed=0, K=12, P=300, N=64):
    """A JAX map and bank with numpy-made random content: valid keyframes
    with poses near a plane at z = 5, points on it, each keyframe's bank row
    binding some points (the incidence mask follows the bindings)."""
    rng = np.random.default_rng(seed)
    m = jstate.empty_map(jstate.MapCapacity(n_kf=16, n_pt=P, n_obs=4 * P))
    bank = jbank.empty_bank(16, N)
    mf = {k: np.array(v) for k, v in H.fields(m).items()}
    bf = {k: np.array(v) for k, v in H.fields(bank).items()}
    mf["kf_valid"][:K] = True
    mf["kf_valid"][4] = False                            # a culled keyframe
    mf["n_kf"] = np.array(K, np.int32)
    for k in range(K):
        R = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.05, 3), jnp.float32)))
        mf["kf_R"][k], mf["kf_t"][k] = R, np.array([-0.3 * k, 0.0, 5.0], np.float32)
    mf["pt_xyz"][:] = np.stack([rng.uniform(-2, 6, P), rng.uniform(-2, 2, P),
                                np.zeros(P)], 1).astype(np.float32)
    mf["pt_valid"][:] = rng.random(P) > 0.1
    mf["n_pt"] = np.array(P, np.int32)
    mask = np.zeros((P, 16), bool)
    for k in range(K):
        pts = rng.choice(P, size=N - 8, replace=False)
        bf["kp_pt"][k, :N - 8] = pts
        bf["valid"][k, :N - 4] = True
        bf["xy"][k] = rng.uniform(0, 300, (N, 2)).astype(np.float32)
        bf["octave"][k] = rng.integers(0, 4, N)
        mask[pts, k] = True
    mf["pt_kf_mask"] = mask
    return (jstate.MapState(**{k: jnp.asarray(v) for k, v in mf.items()}),
            jbank.FeatureBank(**{k: jnp.asarray(v) for k, v in bf.items()}))


@pytest.mark.parametrize("mode", ["temporal", "covis"])
def test_gather_window_problem_bank_matches_jax(mode):
    """The same cameras, points, anchors and observation rows as the JAX
    gather, on a JAX-built map, in both window modes; the point and
    observation caps bind."""
    jm, jb = _random_map()
    kw = dict(window=6, n_levels=4, scale_factor=1.2, cap_cams=8, cap_pts=160, cap_obs=300,
              window_mode=mode, min_anchors=1)
    ref = jax.jit(jmapping.gather_window_problem_bank, static_argnames=tuple(kw))(
        jm, jb, jnp.asarray(10), **kw)
    got = tmapping.gather_window_problem_bank(convert.map_from_numpy(H.fields(jm)),
                                              convert.bank_from_numpy(H.fields(jb)), 10, **kw)
    for name, g, r in zip(("cam_sel", "cam_ok", "pt_sel", "pt_ok"), got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), _np(r), err_msg=name)
    for k in ref[0]._fields:
        r = getattr(ref[0], k)
        if r is None:
            continue
        np.testing.assert_array_equal(getattr(got[0], k).numpy(), _np(r), err_msg=k)
    assert int(got[0].obs_valid.sum()) == 300
    assert bool(got[0].cam_fixed[got[2]].any()) and not bool(got[0].cam_fixed[0])


def test_temporal_window_is_the_chain_up_to_the_center():
    """The temporal window: the `window` keyframes up to the center, valid
    ones only (the refusal of the mono port is gone)."""
    jm, _ = _random_map()
    m = convert.map_from_numpy(H.fields(jm))
    in_window, win_idx = tmapping._window(m, 7, 5, "temporal")
    assert np.nonzero(in_window.numpy())[0].tolist() == [3, 5, 6, 7]
    assert win_idx.tolist() == [7, 6, 5, 4, 3]


# --- the visual-inertial BA ----------------------------------------------------------

def _tproblem(prob):
    d = {k: _t(getattr(prob, k)) for k in prob._fields if k != "factors"}
    return tvi_ba.VIProblem(**{**d, "factors": _tfactor(prob.factors)})


@pytest.fixture(scope="module")
def vi_problem():
    prob, truth = build_vi_problem(seed=3)
    return prob, truth


@pytest.mark.parametrize("schur", ["dense", "pcg"])
@pytest.mark.parametrize("iterations", [3, 12])
def test_vi_bundle_adjust_matches_jax(vi_problem, schur, iterations):
    """test_vi_ba.py's problem (8 keyframes, 150 points, keyframe 0 fixed),
    both reduced solves.  After 3 LM steps (the cost from 8e4 down to ~190)
    poses, velocities and biases within 1e-4, points within 1e-3 relative.
    After 12 the cost sits on a flat minimum (182.7) and the last steps
    move the states by rounding-sized amounts along its weak directions:
    the cost within 1e-3 relative, the states within 1e-3, the points
    within 1e-3 relative (the JAX package's own dense and matrix-free
    solves differ there by up to 5e-3, TestVIBASchurDense)."""
    prob, _ = vi_problem
    ref = jvi_ba.vi_bundle_adjust(prob, "pinhole", VI_K4, iterations=iterations, schur=schur)
    got = tvi_ba.vi_bundle_adjust(_tproblem(prob), "pinhole", _t(VI_K4), iterations=iterations,
                                  schur=schur)
    tol = 1e-4 if iterations == 3 else 1e-3
    for k in ("Rwb", "pwb", "vel", "bias"):
        _close(getattr(got, k), getattr(ref, k), atol=tol, err=k)
    assert _rel(got.X.numpy(), ref.X) < 1e-3
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-3 * float(ref.cost)


def test_vi_bundle_adjust_dense_and_matrix_free_agree(vi_problem):
    """On the port, the dense reduced solve against the matrix-free one
    (TestVIBASchurDense's bounds: costs within 2%, positions within 5e-3),
    and both recover the trajectory (test_vi_ba's bounds)."""
    prob, (R_gt, p_gt, v_gt, _) = vi_problem
    tp = _tproblem(prob)
    r1 = tvi_ba.vi_bundle_adjust(tp, "pinhole", _t(VI_K4), iterations=12, schur="pcg")
    r2 = tvi_ba.vi_bundle_adjust(tp, "pinhole", _t(VI_K4), iterations=12, schur="dense")
    assert abs(float(r1.cost) - float(r2.cost)) < 0.02 * max(float(r1.cost), 1.0)
    assert float((r1.pwb - r2.pwb).abs().max()) < 5e-3
    for r in (r1, r2):
        assert float(torch.linalg.norm(r.pwb - _t(p_gt), dim=-1).max()) < 0.02


def test_vi_bundle_adjust_padded_factor_stack_changes_nothing(vi_problem):
    """The factor stack padded to 16 rows by repeating its first entry
    (masked by `valid`, as the JAX System pads it): the same result as the
    exact stack, within 1e-6."""
    prob, _ = vi_problem
    tp = _tproblem(prob)
    pad = _pad_factors(tp.factors, 16)
    r1 = tvi_ba.vi_bundle_adjust(tp, "pinhole", _t(VI_K4), iterations=6, schur="dense")
    r2 = tvi_ba.vi_bundle_adjust(tp._replace(factors=pad), "pinhole", _t(VI_K4), iterations=6,
                                 schur="dense")
    for a, b in zip(r1, r2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_block_scatter_accumulates_duplicate_indices():
    """T14: `_add_blocks` and `_seg_sum` sum every row of a repeated index,
    as JAX's `.at[].add` does (a plain `x[idx] += v` keeps one write per
    index), against the JAX scatter on the same blocks, exactly."""
    rng = np.random.default_rng(0)
    K, D = 4, 15
    ki = np.array([0, 1, 1, 2, 0], np.int32)
    kj = np.array([1, 2, 2, 3, 1], np.int32)
    X = rng.normal(size=(5, D, D)).astype(np.float32)
    ref = jnp.zeros((K, D, K, D)).at[ki, :, kj, :].add(jnp.asarray(X))
    got = tvi_ba._add_blocks(torch.zeros(K, D, K, D), torch.from_numpy(ki), torch.from_numpy(kj),
                             torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    Xb = X[:, :6, :6]
    ref = jnp.zeros((K, D, K, D)).at[ki, 9:15, kj, 9:15].add(jnp.asarray(Xb))
    got = tvi_ba._add_blocks(torch.zeros(K, D, K, D), torch.from_numpy(ki), torch.from_numpy(kj),
                             torch.from_numpy(Xb), lo=9)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tvi_ba._seg_sum(K, torch.from_numpy(ki), torch.from_numpy(v)).numpy(),
                               _np(jnp.zeros((K, 3)).at[ki].add(v)), rtol=1e-6, atol=1e-6)
    plain = torch.zeros(K, 3)
    plain[torch.from_numpy(ki).long()] += torch.from_numpy(v)
    assert not torch.allclose(plain, tvi_ba._seg_sum(K, torch.from_numpy(ki), torch.from_numpy(v)))
