"""Parity of the port's tracking modules (orbslam3_tpu_torch) with the JAX package.

Inputs come from numpy with a seed; state crosses between the two packages
through `orbslam3_tpu_torch.slam_map.convert`, so that both sides compute on
the same map, view and feature frame.  Tolerances are stated with their
reasons.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.ops import matching as jmatch
from orbslam3_tpu.ops import smallsolve as jsolve
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.pipeline import tracking as jtracking
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu.solver import pose_opt as jpose
from orbslam3_tpu.solver import robust as jrobust
from orbslam3_tpu_torch.ops import cameras as tcam
from orbslam3_tpu_torch.ops import lie as tlie
from orbslam3_tpu_torch.ops import matching as tmatch
from orbslam3_tpu_torch.ops import smallsolve as tsolve
from orbslam3_tpu_torch.pipeline import mapping as tmapping
from orbslam3_tpu_torch.pipeline import tracking as ttracking
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map import state as tstate
from orbslam3_tpu_torch.solver import pose_opt as tpose
from orbslam3_tpu_torch.solver import robust as trobust
from orbslam3_tpu_torch.utils import seeded_scene as ss

torch.set_num_threads(2)

K4 = np.array([400.0, 400.0, 188.0, 120.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(ref), rtol=0, atol=tol)


# --------------------------------------------------------------------- lie
def _rotvecs(rng):
    w = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    w[:4] *= 1e-5                                    # near zero (Taylor branch)
    w[4:8] = w[4:8] / np.linalg.norm(w[4:8], axis=1, keepdims=True) * (np.pi - 1e-4)
    return w


def test_lie_matches_jax():
    """Float32 on both sides; 1e-5 covers reordered 3-term sums and the
    transcendental functions' last-ulp differences."""
    rng = np.random.default_rng(0)
    w = _rotvecs(rng)
    xi = rng.normal(0, 0.5, (64, 6)).astype(np.float32)
    _close(tlie.hat(_t(w)), jlie.hat(w), 0)
    R = np.asarray(jlie.exp_so3(w))
    _close(tlie.exp_so3(_t(w)), R, 1e-5)
    _close(tlie.log_so3(_t(R)), jlie.log_so3(R), 1e-4)  # near pi: arcsin branch
    _close(tlie.normalize_rotation(_t(R * 1.001)), jlie.normalize_rotation(R * 1.001), 1e-5)
    Rj, tj = jlie.se3_exp(xi)
    Rt, tt = tlie.se3_exp(_t(xi))
    _close(Rt, Rj, 1e-5)
    _close(tt, tj, 1e-5)
    x = rng.normal(0, 2, (64, 3)).astype(np.float32)
    for a, b in zip(tlie.se3_inverse(Rt, tt), jlie.se3_inverse(Rj, tj)):
        _close(a, b, 1e-5)
    for a, b in zip(tlie.se3_compose(Rt, tt, Rt.flip(0), tt.flip(0)),
                    jlie.se3_compose(Rj, tj, Rj[::-1], tj[::-1])):
        _close(a, b, 1e-5)
    _close(tlie.se3_apply(Rt, tt, _t(x)), jlie.se3_apply(Rj, tj, x), 1e-5)


def test_pinhole_camera_matches_jax():
    rng = np.random.default_rng(1)
    xc = rng.normal(0, 1, (50, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    uv = rng.uniform(0, 300, (50, 2)).astype(np.float32)
    _close(tcam.project("pinhole", _t(K4), _t(xc)), jcam.project("pinhole", K4, xc), 1e-4)
    _close(tcam.pinhole_unproject(_t(K4), _t(uv)), jcam.unproject("pinhole", K4, uv), 1e-6)
    _close(tcam.project_jac("pinhole", _t(K4), _t(xc)),
           jcam.project_jac("pinhole", K4, xc), 1e-4)
    # the KB8 model through the same dispatch: pixels within 1e-4, the
    # Jacobian (analytic here, forward-mode AD in JAX) within 1e-4 relative
    kb8 = np.array([190.98, 190.97, 254.93, 256.90, 0.00348, 0.000715, -0.00205, 0.000203],
                   np.float32)
    _close(tcam.project("kb8", _t(kb8), _t(xc)), jcam.project("kb8", kb8, xc), 1e-4)
    jac = np.asarray(jcam.project_jac("kb8", kb8, xc))
    _close(tcam.project_jac("kb8", _t(kb8), _t(xc)), jac, 1e-4 * np.abs(jac).max())


# ---------------------------------------------------------------- matching
def test_argmin_takes_the_first_minimum():
    d = torch.tensor([[5, 2, 2, 7], [1, 1, 1, 1], [9, 8, 3, 3]], dtype=torch.int32)
    assert torch.argmin(d, dim=1).tolist() == [1, 0, 2]
    assert np.asarray(jnp.argmin(jnp.asarray(d.numpy()), axis=1)).tolist() == [1, 0, 2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_nn_matches_jax_with_ties(seed):
    """Few distinct descriptors, so distances tie within rows (argmin takes
    the first) and several rows claim one column (lowest (dist, row) wins)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2 ** 32, (12, 8), dtype=np.uint64).astype(np.uint32)
    a = base[rng.integers(0, 12, 60)]
    b = base[rng.integers(0, 12, 45)]
    flip = rng.random((45, 8)) < 0.1
    b = np.where(flip, b ^ np.uint32(1 << 3), b).astype(np.uint32)
    mask = rng.random((60, 45)) < 0.6
    for kw in ({}, {"max_dist": 100, "nn_ratio": 0.8}):
        ref = jmatch.match_nn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), **kw)
        got = tmatch.match_nn(_t(a.view(np.int32)), _t(b.view(np.int32)), _t(mask), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_projection_mask_matches_jax():
    rng = np.random.default_rng(3)
    uv = rng.uniform(0, 100, (80, 2)).astype(np.float32)
    pred = rng.integers(0, 4, 80).astype(np.int32)
    pv = rng.random(80) < 0.8
    xy = rng.uniform(0, 100, (70, 2)).astype(np.float32)
    octv = rng.integers(0, 4, 70).astype(np.int32)
    kv = rng.random(70) < 0.9
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    ref = jmatch.projection_mask(uv, pred, pv, xy, octv, kv, sf, 15.0)
    got = tmatch.projection_mask(_t(uv), _t(pred), _t(pv), _t(xy), _t(octv), _t(kv),
                                 _t(sf), 15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------- solvers
def test_robust_and_solve_psd_match_jax():
    rng = np.random.default_rng(4)
    chi2 = rng.uniform(0, 20, 100).astype(np.float32)
    _close(trobust.huber_weight(_t(chi2), trobust.HUBER_MONO),
           jrobust.huber_weight(chi2, jrobust.HUBER_MONO), 1e-7)
    M = rng.normal(0, 1, (5, 6, 6)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(0, 1, (5, 6)).astype(np.float32)
    # the same unrolled scalar steps on both sides
    _close(tsolve.solve_psd(_t(A), _t(b)), jsolve.solve_psd(A, b), 1e-5)


def _pose_problem(rng, n=300):
    R = np.asarray(jlie.exp_so3(np.array([0.05, -0.02, 0.03], np.float32)))
    t = np.array([0.1, -0.2, 0.3], np.float32)
    X = rng.uniform(-3, 3, (n, 3)).astype(np.float32) + np.array([0, 0, 6], np.float32)
    uv = np.asarray(jcam.pinhole_project(K4, jlie.se3_apply(R, t, X)))
    uv = uv + rng.normal(0, 0.7, uv.shape).astype(np.float32)
    uv[:30] += rng.uniform(10, 40, (30, 2)).astype(np.float32)   # outliers
    octave = rng.integers(0, 4, n)
    inv_s2 = (1.0 / (1.2 ** octave) ** 2).astype(np.float32)
    valid = rng.random(n) < 0.95
    R0 = np.asarray(jlie.exp_so3(np.array([0.06, -0.01, 0.025], np.float32)))
    t0 = t + np.array([0.05, 0.02, -0.04], np.float32)
    return R0, t0, X, uv.astype(np.float32), inv_s2, valid


def test_pose_optimization_matches_jax():
    """12 Gauss-Newton steps from the same start: R and t within 1e-5 (the
    7x7 normal matrix is summed in another order), and the same inliers."""
    R0, t0, X, uv, inv_s2, valid = _pose_problem(np.random.default_rng(5))
    ref = jpose.pose_optimization(R0, t0, X, uv, inv_s2, valid, "pinhole", K4)
    got = tpose.pose_optimization(_t(R0), _t(t0), _t(X), _t(uv), _t(inv_s2),
                                  _t(valid), "pinhole", _t(K4))
    _close(got.R, ref.R, 1e-5)
    _close(got.t, ref.t, 1e-5)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)


# ------------------------------------------------------------------- state
def _assert_state_equal(got, ref):
    rf = H.fields(ref)
    for k, v in convert.to_numpy(got).items():
        r = rf[k].view(np.int32) if rf[k].dtype == np.uint32 else rf[k]
        np.testing.assert_array_equal(v, r, err_msg=k)


def test_map_state_ops_match_jax():
    """Appends past capacity (dropped writes), incidence, covisibility and
    the local view, field by field and exactly."""
    rng = np.random.default_rng(6)
    jcap = jstate.MapCapacity(n_kf=4, n_pt=40, n_obs=90)
    tcap = tstate.MapCapacity(n_kf=4, n_pt=40, n_obs=90)
    mj, mt = jstate.empty_map(jcap), tstate.empty_map(tcap)
    _assert_state_equal(mt, mj)
    chunks = []
    for k in range(5):                       # the 5th keyframe overflows
        R = np.asarray(jlie.exp_so3(rng.normal(0, 0.1, 3).astype(np.float32)))
        t = rng.normal(0, 1, 3).astype(np.float32)
        mj, kj = jstate.add_keyframe(mj, R, t, 0.1 * k, k)
        mt, kt = tstate.add_keyframe(mt, _t(R), _t(t), 0.1 * k, k)
        X = rng.normal(0, 1, (12, 3)).astype(np.float32)
        desc = rng.integers(0, 2 ** 32, (12, 8), dtype=np.uint64).astype(np.uint32)
        nrm, mn, mx = jmapping.point_descriptor_stats(
            X, desc, t, np.arange(12) % 4, 1.2, 4)
        nrm_t, mn_t, mx_t = tmapping.point_descriptor_stats(
            _t(X), None, _t(t), torch.arange(12) % 4, 1.2, 4)
        _close(nrm_t, nrm, 1e-6)
        _close(mx_t, mx, 1e-5)
        v = rng.random(12) < 0.8
        mj, pj = jstate.add_points(mj, X, desc, nrm, mn, mx, kj, k, v)
        mt, pt = tstate.add_points(mt, _t(X), _t(desc.view(np.int32)), _t(np.asarray(nrm)),
                                   _t(np.asarray(mn)), _t(np.asarray(mx)), kt, k, _t(v))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        chunks.append((pj, pt))
    for k in range(4):
        for pj, pt in chunks:
            uv = rng.uniform(0, 100, (12, 2)).astype(np.float32)
            octv = rng.integers(0, 4, 12).astype(np.int32)
            vis = rng.random(12) < 0.7
            mj = jstate.add_observations(mj, k, pj, uv, octv, vis)
            mt = tstate.add_observations(mt, k, pt, _t(uv), _t(octv), _t(vis))
    _assert_state_equal(mt, mj)                 # n_obs saturated at 90
    np.testing.assert_array_equal(tstate.live_incidence(mt).numpy(),
                                  np.asarray(jstate.live_incidence(mj)))
    for c in range(4):
        np.testing.assert_array_equal(tstate.covisibility_weights(mt, c).numpy(),
                                      np.asarray(jstate.covisibility_weights(mj, c)))
        for a, b in zip(tstate.gather_local_view(mt, c, 30, window=3),
                        jstate.gather_local_view(mj, c, 30, window=3)):
            b = np.asarray(b)
            np.testing.assert_array_equal(a.numpy(), b.view(np.int32) if b.dtype == np.uint32 else b)
    for a, b in zip(tstate.full_view(mt), jstate.full_view(mj)):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy(), b.view(np.int32) if b.dtype == np.uint32 else b)


def test_convert_round_trip():
    mj = jstate.empty_map(jstate.MapCapacity(n_kf=3, n_pt=10, n_obs=20))
    mt = convert.map_from_numpy(H.fields(mj))
    _assert_state_equal(mt, mj)
    assert mt.pt_desc.dtype == torch.int32


# ---------------------------------------------------------------- tracking
@pytest.fixture(scope="module")
def seeded():
    """The small seeded map built by the JAX package, the next frame's JAX
    features, and a guess 1 cm / 0.3 degrees off the ground truth."""
    cfg = H.SMALL
    frames = ss.render_frames(cfg)
    mj, _, vj = H.seed_map_jax(cfg, frames)
    fi = cfg.track_frames[0]
    ffj = jx.extract_jit(jnp.asarray(frames[fi]), H.jax_params(cfg))
    R, t = ss.bench_pose(fi)
    dR = np.asarray(jlie.exp_so3(np.array([0.003, -0.002, 0.004], np.float32)))
    return cfg, mj, vj, ffj, (dR @ R).astype(np.float32), t + np.float32(0.01)


@pytest.mark.parametrize("with_view", [True, False])
def test_track_local_map_matches_jax(seeded, with_view):
    """Same map, view and FeatureFrame on both sides: identical matches and
    inliers, R and t within 1e-5 (the pose optimizer's float32 sums run in
    another order)."""
    cfg, mj, vj, ffj, Rg, tg = seeded
    p = H.jax_params(cfg)
    cam = np.asarray(cfg.K4, np.float32)
    ref = jtracking.track_local_map(mj, ffj, Rg, tg, "pinhole", cam, cfg.hw,
                                    p.scale_factor, p.n_levels, radius_th=4.0,
                                    view=vj if with_view else None)
    mt = convert.map_from_numpy(H.fields(mj))
    vt = convert.view_from_numpy(H.fields(vj)) if with_view else None
    fft = convert.frame_from_numpy(H.fields(ffj))
    got = ttracking.track_local_map(mt, fft, _t(Rg), _t(tg), "pinhole", _t(cam),
                                    cfg.hw, p.scale_factor, p.n_levels,
                                    radius_th=4.0, view=vt)
    assert int(ref.n_inliers) >= cfg.min_inliers
    assert int(got.n_matches) == int(ref.n_matches)
    assert int(got.n_inliers) == int(ref.n_inliers)
    for name in ("kp_pt", "kp_inlier", "pt_matched", "pt_visible"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    _close(got.R, ref.R, 1e-5)
    _close(got.t, ref.t, 1e-5)
    m2t = ttracking.update_point_stats(mt, got)
    m2j = jtracking.update_point_stats(mj, ref)
    np.testing.assert_array_equal(m2t.pt_found.numpy(), np.asarray(m2j.pt_found))
    np.testing.assert_array_equal(m2t.pt_visible.numpy(), np.asarray(m2j.pt_visible))


def test_predict_scale_matches_jax():
    rng = np.random.default_rng(7)
    dist = rng.uniform(0.5, 8, 200).astype(np.float32)
    mx = (dist * 1.2 ** rng.integers(0, 8, 200)).astype(np.float32)
    mx[:5] = np.inf                      # empty slots: saturate to the top level
    mx[5:10] = 0.0
    np.testing.assert_array_equal(
        ttracking.predict_scale(_t(dist), _t(mx), 1.2, 8).numpy(),
        np.asarray(jtracking.predict_scale(dist, mx, 1.2, 8)))
