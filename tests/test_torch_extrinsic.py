"""A camera-body extrinsic other than the identity, port against JAX.

Every other inertial parity test uses Rcb = I, tcb = 0, and EuRoC's own Tbc
is not the identity.  Here Tbc is a rotation of ~0.1 rad with a 7 cm
offset, and the scenes are generated with it: the observations are the
projections of camera coordinates Xc = Rcb Rwb^T (X - pwb) + tcb.  Covered:
the InertialSystem's body / camera conversions (`_cam_to_body`,
`_body_to_cam`, `_kf_body_poses`), both VI pose optimizations and
`vi_bundle_adjust` with both reduced solves (the post-loop full inertial BA
with the same extrinsic is in `test_torch_inertial_system.py`).  Each test
states its tolerance beside what it measured.
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
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.solver import inertial as jinertial
from orbslam3_tpu.solver import vi_ba as jvi_ba
from orbslam3_tpu.solver import vi_pose_opt as jvpo
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.solver import vi_ba as tvi_ba
from orbslam3_tpu_torch.solver import vi_pose_opt as tvpo
from test_inertial import CALIB
from test_vi_ba import K4 as VI_K4, build_vi_problem

torch.set_num_threads(2)

R_BC = np.asarray(jlie.exp_so3(jnp.asarray([0.05, -0.07, 0.04], jnp.float32)))
T_BC = np.array([0.05, -0.04, 0.03], np.float32)          # 7.1 cm
R_CB = R_BC.T
T_CB = (-R_BC.T @ T_BC).astype(np.float32)
G = np.asarray(jimu.GRAVITY)


def _t(x):
    return torch.from_numpy(np.array(jax.device_get(x)))


def _np(x):
    return np.asarray(jax.device_get(x))


def _rel(got, ref):
    ref = _np(ref).astype(np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


def test_body_camera_conversions_match_jax():
    """`_cam_to_body`, `_body_to_cam` and `_kf_body_poses` of an
    InertialSystem given this Tbc, on 12 random poses: within 1e-6; and the
    two conversions invert each other."""
    Tbc = tuple(np.block([[R_BC, T_BC[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]])
                .astype(np.float64).reshape(-1))
    cap = dict(n_kf=16, n_pt=64, n_obs=128)
    js = jis.InertialSystem(jsystem.SlamConfig(map_capacity=jsystem.mapstate.MapCapacity(**cap),
                                               enable_relocalization=False),
                            jis.InertialConfig(Tbc=Tbc))
    ts = tis.InertialSystem(tsystem.SlamConfig(map_capacity=MapCapacity(**cap),
                                               enable_relocalization=False),
                            tis.InertialConfig(Tbc=Tbc), device="cpu")
    rng = np.random.default_rng(0)
    R = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)))
    t = rng.normal(size=(16, 3)).astype(np.float32)
    for k in range(12):
        for fn in ("_cam_to_body", "_body_to_cam"):
            ref = getattr(js, fn)(jnp.asarray(R[k]), jnp.asarray(t[k]))
            got = getattr(ts, fn)(torch.from_numpy(R[k].copy()), torch.from_numpy(t[k].copy()))
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-6, err_msg=fn)
        back = ts._body_to_cam(*ts._cam_to_body(torch.from_numpy(R[k].copy()),
                                                torch.from_numpy(t[k].copy())))
        np.testing.assert_allclose(back[0].numpy(), R[k], atol=1e-6)
        np.testing.assert_allclose(back[1].numpy(), t[k], atol=1e-5)
    # every keyframe slot at once: the JAX package converts them one by one
    m = convert.map_from_numpy(H.fields(js.map))._replace(kf_R=torch.from_numpy(R.copy()),
                                                        kf_t=torch.from_numpy(t.copy()))
    got = ts._kf_body_poses(m)
    ref = jax.vmap(js._cam_to_body)(jnp.asarray(R), jnp.asarray(t))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-5)


def _frame_scene(seed, n_pt=60):
    """test_torch_inertial's frame scene (two body states under constant
    acceleration, 10 IMU samples, points at depth 4-6, four outliers) seen
    through the extrinsic."""
    rng = np.random.default_rng(seed)
    dt, n = 0.05, 10
    a_w = np.array([0.4, -0.2, 0.1])
    vp = np.array([0.3, 0.0, 0.1], np.float32)
    acc = np.tile((a_w - G).astype(np.float32), (n, 1))
    pc = (vp * dt + 0.5 * a_w * dt * dt).astype(np.float32)
    vc = (vp + a_w * dt).astype(np.float32)
    X = rng.normal(0, 1.0, (n_pt, 3)).astype(np.float32)
    X[:, 2] = 4.0 + rng.uniform(0, 2, n_pt)
    X = X + pc
    Xc = (X - pc) @ R_CB.T + T_CB
    uv = np.stack([VI_K4[0] * Xc[:, 0] / Xc[:, 2] + VI_K4[2],
                   VI_K4[1] * Xc[:, 1] / Xc[:, 2] + VI_K4[3]], 1).astype(np.float32)
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:4] += 40.0
    pre = jimu.preintegrate(jnp.asarray(acc), jnp.zeros((n, 3)), jnp.full(n, dt / n),
                            jnp.ones(n, bool), CALIB, jnp.zeros(6))
    f = jinertial.stack_preints([pre], [0], [1], capacity=1)
    vis = (X, uv, np.ones(n_pt, np.float32), np.ones(n_pt, bool))
    return dict(pc=pc, vc=vc, vp=vp, f=f, vis=vis)


def _check_pose(got, ref):
    """The same inliers; state within 1e-5 (measured 1e-6); H within 1e-4
    relative (measured 1e-5)."""
    np.testing.assert_array_equal(got.inliers.numpy(), _np(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) == 56
    for k in ("Rwb", "pwb", "vel", "bias"):
        np.testing.assert_allclose(getattr(got, k).numpy(), _np(getattr(ref, k)), atol=1e-5,
                                   err_msg=k)
    assert _rel(got.H.numpy(), ref.H) < 1e-4


def test_vi_pose_optimizations_with_the_extrinsic_match_jax():
    """PoseInertialOptimizationLastKeyFrame and ...LastFrame through the
    extrinsic, from perturbed states: as `_check_pose` states, the
    LastFrame prior's H within 1e-4 relative."""
    eye, z3, z6 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.zeros(6, np.float32)
    ext_j = (jnp.asarray(R_CB), jnp.asarray(T_CB), jimu.GRAVITY)
    ext_t = (torch.from_numpy(R_CB.copy()), torch.from_numpy(T_CB.copy()), _t(G))
    s = _frame_scene(1)
    args = (eye, s["pc"] + 0.05, s["vc"] + 0.1, z6, eye, z3, s["vp"], z6)
    ref = jax.jit(jvpo.vi_pose_optimization, static_argnums=(13,))(
        *map(jnp.asarray, args), s["f"], *map(jnp.asarray, s["vis"]), "pinhole", VI_K4, *ext_j)
    got = tvpo.vi_pose_optimization(*map(_t, args), convert.factor_from_numpy(H.fields(s["f"])),
                                    *map(_t, s["vis"]), "pinhole", _t(VI_K4), *ext_t)
    _check_pose(got, ref)
    s = _frame_scene(2)
    prior = (eye, z3, s["vp"], z6, (np.eye(15) * 1e4).astype(np.float32))
    cur = (eye, s["pc"] + 0.05, s["vc"] + 0.1, z6)
    ref, ref_prior = jax.jit(jvpo.vi_pose_optimization_last_frame, static_argnums=(10,))(
        *map(jnp.asarray, cur), jvpo.VIPosePrior(*map(jnp.asarray, prior)), s["f"],
        *map(jnp.asarray, s["vis"]), "pinhole", VI_K4, *ext_j)
    got, got_prior = tvpo.vi_pose_optimization_last_frame(
        *map(_t, cur), tvpo.VIPosePrior(*map(_t, prior)),
        convert.factor_from_numpy(H.fields(s["f"])), *map(_t, s["vis"]), "pinhole",
        _t(VI_K4), *ext_t)
    _check_pose(got, ref)
    assert _rel(got_prior.H.numpy(), ref_prior.H) < 1e-4


@pytest.fixture(scope="module")
def vi_problem():
    """test_vi_ba.py's problem (8 keyframes, 150 points, keyframe 0 fixed)
    with its observations made through the extrinsic."""
    prob, (R, p, _, X) = build_vi_problem(seed=3)
    Xb = jnp.einsum("kji,knj->kni", R, jnp.asarray(X)[None] - p[:, None])
    Xc = Xb @ jnp.asarray(R_CB).T + jnp.asarray(T_CB)
    uv = jnp.asarray(VI_K4)[:2] * Xc[..., :2] / Xc[..., 2:3] + jnp.asarray(VI_K4)[2:]
    uv = uv.reshape(-1, 2) + 0.3 * jax.random.normal(jax.random.PRNGKey(3), (uv.size // 2, 2))
    return prob._replace(obs_uv=uv, obs_valid=Xc.reshape(-1, 3)[:, 2] > 0.5,
                         Rcb=jnp.asarray(R_CB), tcb=jnp.asarray(T_CB))


@pytest.mark.parametrize("schur", ["dense", "pcg"])
def test_vi_bundle_adjust_with_the_extrinsic_matches_jax(vi_problem, schur):
    """3 LM steps of the VI BA through the extrinsic, both reduced solves:
    poses, velocities and biases within 1e-3 (measured up to 4.4e-4), points within 1e-3
    relative (measured 6.6e-4), the cost within 5e-3 relative (measured
    1.6e-3)."""
    prob = vi_problem
    ref = jvi_ba.vi_bundle_adjust(prob, "pinhole", VI_K4, iterations=3, schur=schur)
    d = {k: _t(getattr(prob, k)) for k in prob._fields if k != "factors"}
    got = tvi_ba.vi_bundle_adjust(
        tvi_ba.VIProblem(**d, factors=convert.factor_from_numpy(H.fields(prob.factors))),
        "pinhole", _t(VI_K4), iterations=3, schur=schur)
    for k in ("Rwb", "pwb", "vel", "bias"):
        np.testing.assert_allclose(getattr(got, k).numpy(), _np(getattr(ref, k)), atol=1e-3,
                                   err_msg=k)
    assert _rel(got.X.numpy(), ref.X) < 1e-3
    assert abs(float(got.cost) - float(ref.cost)) <= 5e-3 * float(ref.cost)
