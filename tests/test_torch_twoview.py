"""The port's two-view initialization against the JAX package's.

Every comparison feeds both packages the same numpy inputs: the scenes of
`tests/test_twoview.py` (`make_pair`) as numpy arrays.  `reconstruct` draws
its RANSAC samples from a generator that differs between the packages, so
the JAX draw (`jax.random.categorical` with the same key, twoview.py:247-250)
is computed here and injected into the port's `reconstruct(idx=...)`.

Singular vectors are defined up to sign: F and H are compared after scaling
to unit Frobenius norm and a positive largest entry, the motion hypotheses
as sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.geometry import twoview as jtv
from orbslam3_tpu_torch.geometry import twoview as ttv
from test_twoview import K4 as K4_J
from test_twoview import make_pair

torch.set_num_threads(2)

K4_N = np.asarray(K4_J, np.float32)
K4_T = torch.from_numpy(K4_N.copy())


def _scene(name):
    """(uv1, uv2, valid) in numpy and the reconstruct key of the scene as
    `tests/test_twoview.py` builds and runs it."""
    if name == "general":
        uv1, uv2, valid, *_ = make_pair(jax.random.PRNGKey(0))
        key = 1
    elif name == "planar":
        uv1, uv2, valid, *_ = make_pair(jax.random.PRNGKey(2), planar=True, noise=0.3)
        key = 3
    elif name == "outliers":
        uv1, uv2, valid, *_ = make_pair(jax.random.PRNGKey(4))
        n_bad = uv1.shape[0] * 3 // 20   # the share test_twoview.py uses
        uv2 = uv2.at[:n_bad].set(jax.random.uniform(
            jax.random.PRNGKey(5), (n_bad, 2), minval=0, maxval=400))
        key = 6
    else:
        uv1, uv2, valid, *_ = make_pair(jax.random.PRNGKey(7), baseline=0.0, noise=0.2)
        key = 8
    return (np.asarray(uv1, np.float32), np.asarray(uv2, np.float32),
            np.asarray(valid), key)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _unit(M):
    """Unit Frobenius norm and a positive largest-magnitude entry."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def _jax_idx(valid, key):
    w = jnp.asarray(valid).astype(jnp.float32) + 1e-9
    n = jtv.RANSAC_ITERS * jtv.SAMPLE_SIZE
    return np.asarray(jax.random.categorical(
        jax.random.PRNGKey(key), jnp.log(w)[None, :].repeat(n, 0)
    ).reshape(jtv.RANSAC_ITERS, jtv.SAMPLE_SIZE))


def _normalized(uv1, uv2, valid):
    p1, _ = jtv._normalize(jnp.asarray(uv1), jnp.asarray(valid, jnp.float32))
    p2, _ = jtv._normalize(jnp.asarray(uv2), jnp.asarray(valid, jnp.float32))
    return np.asarray(p1), np.asarray(p2)


def _design(fit, p1, p2):
    """The design matrix of `_fit_F` / `_fit_H` in float64."""
    x1, y1, x2, y2 = (a.astype(np.float64) for a in (p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]))
    z, o = np.zeros_like(x1), np.ones_like(x1)
    if fit == "_fit_F":
        return np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], 1)
    return np.concatenate([
        np.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], 1),
        np.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], 1)])


def test_normalize_matches_jax():
    uv1, _, valid, _ = _scene("general")
    pj, Tj = jtv._normalize(jnp.asarray(uv1), jnp.asarray(valid, jnp.float32))
    pt, Tt = ttv._normalize(*_t(uv1, valid.astype(np.float32)))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fit", ["_fit_F", "_fit_H"])
@pytest.mark.parametrize("scene", ["general", "planar"])
def test_fit_matches_jax_up_to_sign(fit, scene):
    """Minimal 8-point samples (batched in the port, vmapped in JAX) and the
    weighted all-points fit: equal up to sign, 1e-4 after normalising.  The
    minimal-sample F on the planar scene is left out: coplanar points leave
    the 8x9 system with a two-dimensional null space, where the last
    singular vector is not determined."""
    uv1, uv2, valid, key = _scene(scene)
    p1, p2 = _normalized(uv1, uv2, valid)
    w = valid.astype(np.float32)
    ref = getattr(jtv, fit)(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w))
    got = getattr(ttv, fit)(*_t(p1, p2, w))
    np.testing.assert_allclose(_unit(got.numpy()), _unit(ref), atol=1e-4)
    if fit == "_fit_F" and scene == "planar":
        return
    idx = _jax_idx(valid, key)[:32]
    ref_b = jax.vmap(getattr(jtv, fit))(jnp.asarray(p1[idx]), jnp.asarray(p2[idx]))
    got_b = getattr(ttv, fit)(*_t(p1[idx], p2[idx]))
    assert got_b.shape == (32, 3, 3)
    # float32 leaves the null vector of the design matrix uncertain by about
    # eps * s1 / s8 (its largest over its smallest non-zero singular value);
    # a sample that is nearly degenerate, or that draws one match twice (the
    # draw is with replacement), is not determined to 1e-4 and is skipped
    compared = 0
    for i in range(32):
        sv = np.linalg.svd(_design(fit, p1[idx[i]], p2[idx[i]]), compute_uv=False)
        if sv[7] < 5e-4 * sv[0]:
            continue
        compared += 1
        np.testing.assert_allclose(_unit(got_b[i].numpy()), _unit(ref_b[i]), atol=1e-4)
    assert compared >= 24


@pytest.mark.parametrize("model", ["F", "H"])
def test_score_matches_jax(model):
    """Scores within 1e-3 relative, inlier masks equal, single and batched."""
    uv1, uv2, valid, _ = _scene("planar" if model == "H" else "general")
    p1, p2 = _normalized(uv1, uv2, valid)
    w = jnp.asarray(valid, jnp.float32)
    _, T1 = jtv._normalize(jnp.asarray(uv1), w)
    _, T2 = jtv._normalize(jnp.asarray(uv2), w)
    if model == "F":
        M = T2.T @ jtv._fit_F(jnp.asarray(p1), jnp.asarray(p2), w) @ T1
        jscore, tscore = jtv._score_F, ttv._score_F
    else:
        M = jnp.linalg.inv(T2) @ jtv._fit_H(jnp.asarray(p1), jnp.asarray(p2), w) @ T1
        jscore, tscore = jtv._score_H, ttv._score_H
    M = np.asarray(M, np.float32)
    # the fitted model and two perturbed ones, as one batch in the port
    rng = np.random.default_rng(0)
    Ms = np.stack([M, M * (1 + 1e-3 * rng.standard_normal((3, 3)).astype(np.float32)),
                   M * (1 + 1e-2 * rng.standard_normal((3, 3)).astype(np.float32))])
    sc_t, ok_t = tscore(*_t(Ms, uv1, uv2, valid), 1.0)
    assert int(ok_t[0].sum()) > 100
    for i in range(3):
        sc_j, ok_j = jscore(jnp.asarray(Ms[i]), jnp.asarray(uv1), jnp.asarray(uv2),
                            jnp.asarray(valid), 1.0)
        assert float(sc_t[i]) == pytest.approx(float(sc_j), rel=1e-3)
        np.testing.assert_array_equal(ok_t[i].numpy(), np.asarray(ok_j))


def _true_motion():
    from orbslam3_tpu.ops import lie as jlie
    return (np.asarray(jlie.exp_so3(jnp.array([0.02, -0.08, 0.01])), np.float32),
            np.array([-0.5, 0.02, 0.03], np.float32))


def test_check_rt_matches_jax():
    """The true motion, its mirrored translation and a wrong rotation, as
    one batch in the port: counts and masks equal, parallax within 1e-3
    degrees, points within 1e-3 relative where good."""
    uv1, uv2, valid, _ = _scene("general")
    R, t = _true_motion()
    Rs = np.stack([R, R, R.T])
    ts = np.stack([t, -t, t])
    ng_t, par_t, X_t, good_t = ttv._check_rt(*_t(Rs, ts, uv1, uv2, valid), K4_T, 1.0)
    assert int(ng_t[0]) > 200 and int(ng_t[1]) == 0
    for i in range(3):
        ng, par, X, good = jtv._check_rt(jnp.asarray(Rs[i]), jnp.asarray(ts[i]),
                                         jnp.asarray(uv1), jnp.asarray(uv2),
                                         jnp.asarray(valid), K4_J, 1.0)
        assert int(ng_t[i]) == int(ng)
        np.testing.assert_array_equal(good_t[i].numpy(), np.asarray(good))
        assert float(par_t[i]) == pytest.approx(float(par), abs=1e-3)
        g = np.asarray(good)
        np.testing.assert_allclose(X_t[i].numpy()[g], np.asarray(X)[g], rtol=1e-3)


def _motion_set_distance(Rs_a, ts_a, Rs_b, ts_b):
    """Largest distance from a motion of set a to its nearest motion of b."""
    worst = 0.0
    for Ra, ta in zip(Rs_a, ts_a):
        worst = max(worst, min(max(np.abs(Ra - Rb).max(), np.abs(ta - tb).max())
                               for Rb, tb in zip(Rs_b, ts_b)))
    return worst


def test_decompose_E_matches_jax_as_a_set():
    R, t = _true_motion()
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    E = (tx @ R).astype(np.float32)
    R1, R2, tj = (np.asarray(x) for x in jtv._decompose_E(jnp.asarray(E)))
    R1t, R2t, tt = (x.numpy() for x in ttv._decompose_E(torch.from_numpy(E)))
    # U's sign flips t, which permutes the four (R, t) hypotheses
    set_j = ([R1, R2, R1, R2], [tj, tj, -tj, -tj])
    set_t = ([R1t, R2t, R1t, R2t], [tt, tt, -tt, -tt])
    assert _motion_set_distance(*set_t, *set_j) < 1e-4
    assert _motion_set_distance(*set_j, *set_t) < 1e-4
    assert min(np.abs(R1t - R).max(), np.abs(R2t - R).max()) < 1e-4


def test_homography_motions_match_jax_as_a_set():
    uv1, uv2, valid, _ = _scene("planar")
    p1, p2 = _normalized(uv1, uv2, valid)
    w = jnp.asarray(valid, jnp.float32)
    _, T1 = jtv._normalize(jnp.asarray(uv1), w)
    _, T2 = jtv._normalize(jnp.asarray(uv2), w)
    H = jnp.linalg.inv(T2) @ jtv._fit_H(jnp.asarray(p1), jnp.asarray(p2), w) @ T1
    K = np.array([[K4_N[0], 0, K4_N[2]], [0, K4_N[1], K4_N[3]], [0, 0, 1]], np.float32)
    A = (np.linalg.inv(K) @ np.asarray(H) @ K).astype(np.float32)
    Rj, tj, dj = jtv._homography_motions(jnp.asarray(A))
    Rt, tt, dt = ttv._homography_motions(torch.from_numpy(A))
    assert bool(dt) == bool(dj) and not bool(dt)
    assert _motion_set_distance(Rt.numpy(), tt.numpy(), np.asarray(Rj), np.asarray(tj)) < 1e-4
    assert _motion_set_distance(np.asarray(Rj), np.asarray(tj), Rt.numpy(), tt.numpy()) < 1e-4


@pytest.mark.parametrize("scene", ["general", "planar", "outliers", "pure_rotation"])
def test_reconstruct_matches_jax_with_its_samples(scene):
    """JAX's RANSAC indices injected: the same outcome, the same model, the
    same triangulated set, R21 and t21 within 1e-4, points within 1e-3
    relative."""
    uv1, uv2, valid, key = _scene(scene)
    ref = jtv.reconstruct(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), K4_J,
                          jax.random.PRNGKey(key))
    idx = _jax_idx(valid, key)
    got = ttv.reconstruct(*_t(uv1, uv2, valid), K4_T, idx=torch.from_numpy(idx.copy()))
    assert bool(got.success) == bool(ref.success)
    assert bool(got.success) == (scene != "pure_rotation")
    assert bool(got.used_homography) == bool(ref.used_homography)
    if scene in ("general", "planar"):
        assert bool(got.used_homography) == (scene == "planar")
    tri = np.asarray(ref.triangulated)
    np.testing.assert_array_equal(got.triangulated.numpy(), tri)
    if not bool(ref.success):
        return
    assert tri.sum() > 100
    np.testing.assert_allclose(got.R21.numpy(), np.asarray(ref.R21), atol=1e-4)
    np.testing.assert_allclose(got.t21.numpy(), np.asarray(ref.t21), atol=1e-4)
    Xr = np.asarray(ref.points3d)[tri]
    rel = np.linalg.norm(got.points3d.numpy()[tri] - Xr, axis=1) / np.linalg.norm(Xr, axis=1)
    assert rel.max() < 1e-3


@pytest.mark.parametrize("scene", ["general", "planar"])
def test_reconstruct_with_the_ports_own_generator(scene):
    """The port's own draw (a seeded torch generator) reconstructs both
    scenes, with the model the scene calls for and the true motion."""
    uv1, uv2, valid, _ = _scene(scene)
    g = torch.Generator()
    g.manual_seed(0)
    res = ttv.reconstruct(*_t(uv1, uv2, valid), K4_T, generator=g)
    assert bool(res.success)
    assert bool(res.used_homography) == (scene == "planar")
    assert int(res.triangulated.sum()) > 100
    R, _ = _true_motion()
    assert np.abs(res.R21.numpy() - R).max() < 0.05
    idx = ttv.sample_indices(torch.from_numpy(valid), g)
    assert idx.shape == (ttv.RANSAC_ITERS, ttv.SAMPLE_SIZE)
    assert bool(torch.from_numpy(valid)[idx].all())   # only valid matches are drawn
