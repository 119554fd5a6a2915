"""Parity of the port's keyframe-step modules (orbslam3_tpu_torch) with the JAX
package: triangulation, the triangulation matcher's gates, the small solves,
the grid bundle adjustment, the window gathers, the feature bank, point
culling and compaction, and fusion.

Inputs come from numpy with a seed; maps are built with the JAX package and
cross to the port through `orbslam3_tpu_torch.slam_map.convert`, so that both
sides compute on the same state.  Discrete outcomes (selections, masks,
bindings, slots) must be equal; each float tolerance is stated with its reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.features.extractor import FeatureFrame as JFrame
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.ops import matching as jmatch
from orbslam3_tpu.ops import smallsolve as jsolve
from orbslam3_tpu.ops import triangulate as jtri
from orbslam3_tpu.parallel import dist_ba as jdist
from orbslam3_tpu.pipeline import fusion as jfusion
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.slam_map import feature_bank as jbank
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu.solver import ba as jba
from orbslam3_tpu.solver import ba_grid as jbg
from orbslam3_tpu_torch.ops import cameras as tcam
from orbslam3_tpu_torch.ops import matching as tmatch
from orbslam3_tpu_torch.ops import smallsolve as tsolve
from orbslam3_tpu_torch.ops import triangulate as ttri
from orbslam3_tpu_torch.parallel import multihost
from orbslam3_tpu_torch.pipeline import fusion as tfusion
from orbslam3_tpu_torch.pipeline import mapping as tmapping
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map import feature_bank as tbank
from orbslam3_tpu_torch.slam_map import state as tstate
from orbslam3_tpu_torch.solver import ba as tba
from orbslam3_tpu_torch.solver import ba_grid as tbg

torch.set_num_threads(2)

K4 = np.array([400.0, 400.0, 188.0, 120.0], np.float32)
HW = (240, 376)
N_KP = 192


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _equal(got, ref, msg=""):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(ref), err_msg=msg)


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(convert.to_numpy(got), _np(ref), rtol=0, atol=tol,
                               err_msg=msg)


def _fields_equal(got, ref, skip=()):
    rf = H.fields(ref)
    for k, v in convert.to_numpy(got).items():
        if k not in skip:
            np.testing.assert_array_equal(v, _np(rf[k]), err_msg=k)


def _rot(rng, s):
    return np.asarray(jlie.exp_so3(rng.normal(0, s, 3).astype(np.float32)))


# ------------------------------------------------------------ triangulation
def test_triangulate_dlt_matches_jax_and_the_svd_oracle():
    """Same closed-form steps on both sides: within 1e-5 of |X| (float32 3x3
    sums in another order).  On noise-free rays, where the homogeneous and
    the inhomogeneous least squares share their solution, against the exact
    SVD null-space solve (torch's and JAX's): within 1e-4 of |X|, the
    float32 SVD's own accuracy on these systems."""
    rng = np.random.default_rng(0)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 9, n)], 1).astype(np.float32)
    R1, t1 = _rot(rng, 0.02), np.zeros(3, np.float32)
    R2, t2 = _rot(rng, 0.05), np.array([-0.4, 0.05, 0.02], np.float32)
    poses = (np.broadcast_to(R1, (n, 3, 3)), np.broadcast_to(t1, (n, 3)),
             np.broadcast_to(R2, (n, 3, 3)), np.broadcast_to(t2, (n, 3)))
    for noise in (1e-3, 0.0):
        rays = []
        for R, t in ((R1, t1), (R2, t2)):
            Xc = X @ R.T + t
            rays.append((Xc / Xc[:, 2:3] + rng.normal(0, noise, Xc.shape) * [1, 1, 0]
                         ).astype(np.float32))
        args = (rays[0], rays[1], poses[0], poses[1], poses[2], poses[3])
        ref = np.asarray(jtri.triangulate_dlt(*args))
        got = ttri.triangulate_dlt(*map(_t, args)).numpy()
        scale = np.linalg.norm(ref, axis=1, keepdims=True)
        assert np.all(np.abs(got - ref) <= 1e-5 * scale)
    for oracle in (ttri.triangulate_dlt_svd(*map(_t, args)).numpy(),
                   np.asarray(jtri.triangulate_dlt_svd(*args))):
        assert np.all(np.abs(got - oracle) <= 1e-4 * scale)
    # degenerate (parallel) rays stay finite on both sides
    par = (rays[0][:4], rays[0][:4], args[2][:4], args[3][:4], args[2][:4], args[3][:4])
    assert np.isfinite(ttri.triangulate_dlt(*map(_t, par)).numpy()).all()


def test_unproject_matches_jax_and_kb8_raises():
    """Both models' unprojection through the dispatch against JAX: the
    pinhole ray within 1e-6, the KB8 bearing (10 Newton steps) within 1e-5
    of its components; an unknown model raises, as in JAX."""
    uv = np.random.default_rng(1).uniform(0, 300, (50, 2)).astype(np.float32)
    _close(tcam.unproject("pinhole", _t(K4), _t(uv)), jcam.unproject("pinhole", K4, uv), 1e-6)
    kb8 = np.array([190.98, 190.97, 254.93, 256.90, 0.00348, 0.000715, -0.00205, 0.000203],
                   np.float32)
    _close(tcam.unproject("kb8", _t(kb8), _t(uv)), jcam.unproject("kb8", kb8, uv), 1e-5)
    with pytest.raises(ValueError):
        tcam.unproject("ds", _t(K4), _t(uv))


# ------------------------------------------------------------------ matching
def test_epipolar_mask_matches_jax():
    rng = np.random.default_rng(2)
    R1, t1 = _rot(rng, 0.02), np.zeros(3, np.float32)
    R2, t2 = _rot(rng, 0.02), np.array([-0.3, 0.02, 0.0], np.float32)
    F = np.asarray(jmapping.fundamental_from_poses(R1, t1, R2, t2, K4))
    _close(tmapping.fundamental_from_poses(_t(R1), _t(t1), _t(R2), _t(t2), _t(K4)),
           F, 1e-6 * np.abs(F).max())
    xa = rng.uniform(0, 376, (120, 2)).astype(np.float32)
    xb = rng.uniform(0, 376, (110, 2)).astype(np.float32)
    s2 = (1.44 ** rng.integers(0, 4, 110)).astype(np.float32)
    # a wide chi2 bound so that many pairs sit near the line, both sides
    _equal(tmatch.epipolar_mask(_t(xa), _t(xb), _t(F), _t(s2), 3000.0),
           jmatch.epipolar_mask(xa, xb, F, s2, 3000.0))


def test_rotation_histogram_filter_ties_match_jax():
    """Bins 3, 7, 12 and 20 tie at 5 votes: the top three are the lower
    bins, as lax.top_k keeps; negative, 360-degree and half-bin angles wrap
    into bin 0 (4 votes)."""
    votes = {3: 5, 7: 5, 12: 5, 20: 5, 25: 1, 0: 2}
    rot = np.concatenate([np.full(c, b * 12.0) for b, c in votes.items()])
    rot = rot + np.random.default_rng(3).uniform(-4, 4, rot.size)
    rot[-2:] = [-5.9, 359.9]                   # both land in bin 0
    rot = np.concatenate([rot, [6.0, -354.0, 726.0]]).astype(np.float32)  # half-even
    valid = np.ones(rot.size, bool)
    valid[-1] = False
    ref = jmatch.rotation_histogram_filter(rot, valid)
    _equal(tmatch.rotation_histogram_filter(_t(rot), _t(valid)), ref)
    ref = np.asarray(ref)
    assert ref[:15].all() and not ref[15:].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_match_nn_rotation_and_mutual_match_jax(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    a = base[rng.integers(0, 40, 90)]
    b = base[rng.integers(0, 40, 80)]
    flip = rng.random((80, 8)) < 0.3
    b = np.where(flip, b ^ np.uint32(1 << 5), b).astype(np.uint32)
    ang_a = rng.uniform(0, 360, 90).astype(np.float32)
    ang_b = (rng.choice([0.0, 24.0, 48.0], 80) + rng.uniform(-3, 3, 80)).astype(np.float32)
    mask = rng.random((90, 80)) < 0.7
    for kw in ({"mutual": True, "check_rotation": True},
               {"mutual": True}, {"check_rotation": True, "nn_ratio": 0.9}):
        ref = jmatch.match_nn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
                              angles_a=ang_a, angles_b=ang_b, **kw)
        got = tmatch.match_nn(_t(a), _t(b), _t(mask), angles_a=_t(ang_a),
                              angles_b=_t(ang_b), **kw)
        for g, r in zip(got, ref):
            _equal(g, r, str(kw))


# -------------------------------------------------------------- small solves
def test_solve_psd_blocked_matches_jax():
    """K = 8 blocks of 6: the same unrolled block Cholesky on both sides,
    within 1e-5 of |x|; against float64 numpy within 1e-4 of |x| (the
    system's condition number is ~1e2)."""
    rng = np.random.default_rng(4)
    M = rng.normal(0, 1, (48, 48)).astype(np.float32)
    A = (M @ M.T / 48 + np.eye(48)).astype(np.float32)
    b = rng.normal(0, 1, 48).astype(np.float32)
    ref = np.asarray(jsolve.solve_psd_blocked(A, b, bs=6))
    got = tsolve.solve_psd_blocked(_t(A), _t(b), bs=6).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-5 * scale
    exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    assert np.abs(got - exact).max() <= 1e-4 * scale


def test_chol3_and_spd_inv3_match_jax():
    rng = np.random.default_rng(5)
    M = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    A = (M @ M.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    Ainv = np.asarray(jba._spd_inv3(A))
    _close(tba._spd_inv3(_t(A)), Ainv, 1e-5 * np.abs(Ainv).max())
    _close(tba._chol3(_t(A)), jba._chol3(A), 1e-5 * np.sqrt(np.abs(A).max()))


# ------------------------------------------------------------- grid BA
def _grid_problem(seed, P=240, K=6):
    """A window problem whose every point is seen by >= 3 cameras (a point
    seen once has a singular 3x3 block that float32 cannot invert), with
    pixel noise, perturbed free cameras and points, one padded camera and
    a few padded points."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 2.5, P), rng.uniform(-1.2, 1.2, P),
                  rng.uniform(4, 7, P)], 1).astype(np.float32)
    R = np.stack([_rot(rng, 0.02) for _ in range(K)])
    t = np.stack([[-0.25 * k, 0.02 * k, 0.0] for k in range(K)]).astype(np.float32)
    Xc = np.einsum("kab,pb->pka", R, X) + t[None]
    uv = np.asarray(jcam.pinhole_project(K4, Xc)) + rng.normal(0, 0.5, (P, K, 2))
    valid = rng.random((P, K)) < 0.8
    valid[:, :3] |= True
    cam_valid = np.arange(K) < K - 1
    valid &= cam_valid[None]
    octave = rng.integers(0, 4, (P, K))
    fixed = np.arange(K) < 2
    dR = np.stack([_rot(rng, 0.004) if not f else np.eye(3) for f in fixed])
    pt_valid = np.arange(P) < P - 10
    return jbg.GridBAProblem(
        R=jnp.asarray((dR @ R).astype(np.float32)),
        t=jnp.asarray(t + np.where(fixed[:, None], 0, rng.normal(0, 0.02, (K, 3))).astype(np.float32)),
        cam_fixed=jnp.asarray(fixed), cam_valid=jnp.asarray(cam_valid),
        X=jnp.asarray(X + rng.normal(0, 0.03, X.shape).astype(np.float32)),
        pt_valid=jnp.asarray(pt_valid),
        uv=jnp.asarray(uv.astype(np.float32)),
        inv_sigma2=jnp.asarray(np.where(valid, 1.44 ** -octave, 0.0).astype(np.float32)),
        valid=jnp.asarray(valid), ur=jnp.full((P, K), -1.0, jnp.float32))


def _to_torch_problem(prob):
    return tbg.GridBAProblem(**{k: _t(v) for k, v in H.fields(prob).items()})


def test_bundle_adjust_grid_matches_jax():
    """One LM step from the same problem: R, t and X within 1e-5 of their
    scale (the Hcc / Schur contractions sum thousands of float32 terms in
    another order).  Six steps: the same accept pattern keeps the outcome
    within 1e-4 of the scale, and the cost within 1e-4 relative."""
    prob = _grid_problem(6)
    pt = _to_torch_problem(prob)
    for iters, tol in ((1, 1e-5), (6, 1e-4)):
        Rj, tj, Xj, cj = jbg.bundle_adjust_grid(prob, "pinhole", K4, iterations=iters)
        Rt, tt, Xt, ct = tbg.bundle_adjust_grid(pt, "pinhole", _t(K4), iterations=iters)
        _close(Rt, Rj, tol, "R")
        _close(tt, tj, tol * np.abs(np.asarray(tj)).max(), "t")
        _close(Xt, Xj, tol * np.abs(np.asarray(Xj)).max(), "X")
        assert abs(float(ct) - float(cj)) <= 1e-4 * float(cj)
    # the solve converged toward the noise floor: cost per observation ~ 2 sigma^2
    n_obs = int((np.asarray(prob.valid) & np.asarray(prob.pt_valid)[:, None]).sum())
    assert float(ct) < 3.0 * n_obs * 0.25 * 2


def test_grid_step_pieces_match_jax():
    """The Jacobians and the hat/plane products, element by element."""
    prob = _grid_problem(7, P=40)
    pt = _to_torch_problem(prob)
    ej, Jcj, Jpj = jbg._grid_jacobians(prob, prob.R, prob.t, prob.X, "pinhole", K4, 0.0)
    et, Jct, Jpt = tbg._grid_jacobians(pt, pt.R, pt.t, pt.X, "pinhole", _t(K4), 0.0)
    _close(et, ej, 1e-3)
    _close(Jct, Jcj, 1e-5 * np.abs(np.asarray(Jcj)).max())
    _close(Jpt, Jpj, 1e-5 * np.abs(np.asarray(Jpj)).max())
    # stereo rows follow the same formulas
    probs = prob._replace(ur=jnp.where(prob.valid, prob.uv[..., 0] - 20.0, -1.0))
    ej, Jcj, _ = jbg._grid_jacobians(probs, prob.R, prob.t, prob.X, "pinhole", K4, 40.0)
    et, Jct, _ = tbg._grid_jacobians(_to_torch_problem(probs), pt.R, pt.t, pt.X,
                                     "pinhole", _t(K4), 40.0)
    _close(et, ej, 1e-3)
    _close(Jct, Jcj, 1e-5 * np.abs(np.asarray(Jcj)).max())


# ----------------------------------------------------- synthetic keyframe map
def _kf_map(seed, n_kf=6, n_pt=160, cap=(8, 256, 2048)):
    """A JAX-built map of n_kf keyframes moving along x over points 4-8
    units ahead, every point seen by >= 3 keyframes, with the FeatureBank
    rows binding each keyframe's keypoints to the points they observe.

    T13: keyframe 3 binds one point to a second keypoint (a shifted copy),
    and its observation list holds that second row too.  Returns (map,
    bank, per-KF FeatureFrames, per-KF bindings)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.0, 2.2, n_pt), rng.uniform(-0.8, 0.8, n_pt),
                  rng.uniform(4, 8, n_pt)], 1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pt, 8), dtype=np.uint64).astype(np.uint32)
    m = jstate.empty_map(jstate.MapCapacity(*cap))
    bank = jbank.empty_bank(cap[0], N_KP)
    poses = [(_rot(rng, 0.01), np.array([-0.22 * k, 0.01 * k, 0.0], np.float32))
             for k in range(n_kf)]
    seen = np.zeros((n_pt, n_kf), bool)
    for k, (R, t) in enumerate(poses):
        uv = np.asarray(jcam.pinhole_project(K4, X @ R.T + t))
        inside = (uv[:, 0] > 5) & (uv[:, 0] < HW[1] - 5) & (uv[:, 1] > 5) & (uv[:, 1] < HW[0] - 5)
        seen[:, k] = inside & (rng.random(n_pt) < 0.85)
    keep = seen.sum(1) >= 3
    d = np.linalg.norm(X, axis=1)
    for k, (R, t) in enumerate(poses):
        m, _ = jstate.add_keyframe(m, R, t, 0.1 * k, 6 * k)
    m, pidx = jstate.add_points(m, X, desc, np.zeros_like(X), d / 3.6, d * 1.5,
                                0, 0, jnp.asarray(keep))
    pidx = np.asarray(pidx)
    ffs, binds = [], []
    for k, (R, t) in enumerate(poses):
        pts = np.nonzero(seen[:, k] & keep)[0][:N_KP - 1]
        uv = np.asarray(jcam.pinhole_project(K4, X[pts] @ R.T + t))
        xy = np.zeros((N_KP, 2), np.float32)
        xy[:len(pts)] = uv + rng.normal(0, 0.4, uv.shape)
        kp_pt = np.full(N_KP, -1, np.int32)
        kp_pt[:len(pts)] = pidx[pts]
        dsc = np.zeros((N_KP, 8), np.uint32)
        dsc[:len(pts)] = desc[pts] ^ np.uint32(1 << 7)
        valid = np.arange(N_KP) < len(pts)
        if k == 3:                                        # T13 duplicate row
            xy[len(pts)] = xy[0] + [2.5, -1.5]
            kp_pt[len(pts)] = kp_pt[0]
            dsc[len(pts)] = dsc[0]
            valid[len(pts)] = True
        octave = rng.integers(0, 4, N_KP).astype(np.int32)
        ff = JFrame(xy=jnp.asarray(xy), response=jnp.zeros(N_KP), octave=jnp.asarray(octave),
                    angle=jnp.asarray(rng.uniform(0, 360, N_KP).astype(np.float32)),
                    desc=jnp.asarray(dsc), valid=jnp.asarray(valid))
        m = jstate.add_observations(m, k, jnp.asarray(kp_pt), ff.xy, ff.octave, ff.valid)
        bank = jbank.set_frame(bank, k, ff, jnp.asarray(kp_pt))
        ffs.append(ff)
        binds.append(kp_pt)
    return m, bank, ffs, binds


def _perturbed(m, seed):
    """The same map with the free keyframes and the points moved a little,
    so that the window BA has work to do."""
    rng = np.random.default_rng(seed)
    K = m.kf_t.shape[0]
    dt = np.where((np.arange(K) >= 2)[:, None], rng.normal(0, 0.01, (K, 3)), 0.0)
    return m._replace(kf_t=m.kf_t + jnp.asarray(dt, jnp.float32),
                      pt_xyz=m.pt_xyz + jnp.asarray(
                          rng.normal(0, 0.02, m.pt_xyz.shape), jnp.float32))


@pytest.fixture(scope="module")
def kf_map():
    return _kf_map(8)


@pytest.mark.parametrize("source", ["coo", "bank"])
def test_gather_window_grid_matches_jax(kf_map, source):
    """Selections, anchors and the grid equal, including the slot a
    duplicate (point, KF) row writes twice (T13: the last row wins), under
    point and camera caps that bind."""
    mj, bj, _, binds = kf_map
    mt, bt = convert.map_from_numpy(H.fields(mj)), convert.bank_from_numpy(H.fields(bj))
    for center, cap_cams, cap_pts in ((5, 8, 256), (5, 4, 100), (3, 8, 64)):
        if source == "bank":
            ref = jmapping.gather_window_grid_bank(mj, bj, jnp.asarray(center), 8, 4, 1.2,
                                                   "pinhole", K4, cap_cams=cap_cams,
                                                   cap_pts=cap_pts)
            got = tmapping.gather_window_grid_bank(mt, bt, center, 8, 4, 1.2, "pinhole",
                                                   _t(K4), cap_cams=cap_cams, cap_pts=cap_pts)
        else:
            ref = jmapping.gather_window_grid(mj, jnp.asarray(center), 8, 4, 1.2,
                                              cap_cams=cap_cams, cap_pts=cap_pts)
            got = tmapping.gather_window_grid(mt, center, 8, 4, 1.2,
                                              cap_cams=cap_cams, cap_pts=cap_pts)
        for name, g, r in zip(("cam_sel", "cam_ok", "pt_sel", "pt_ok"), got[1:], ref[1:]):
            _equal(g, r, f"{name} {center} {cap_cams} {cap_pts}")
        _fields_equal(got[0], ref[0])
    # the duplicate's slot holds the second keypoint's xy in both packages
    dup = int(binds[3][0])
    sel = np.asarray(ref[3]).tolist()
    if dup in sel:
        col = np.asarray(ref[1]).tolist().index(3)
        _equal(got[0].uv[sel.index(dup), col], ref[0].uv[sel.index(dup), col])


def test_run_local_ba_matches_jax(kf_map):
    """Bank-sourced window BA, 6 LM steps, written back: the same free
    cameras move; poses within 1e-4 and points within 1e-3 of their scale
    (the accept pattern is the same, the float32 sums are not).  The same
    window with GNSS position priors goes to the COO solver in both and is
    held to the same tolerances."""
    mj, bj, _, _ = kf_map
    mj = _perturbed(mj, 9)
    mt, bt = convert.map_from_numpy(H.fields(mj)), convert.bank_from_numpy(H.fields(bj))
    kw = dict(window=8, iterations=6, scale_factor=1.2, n_levels=4, cap_cams=8, cap_pts=256)
    ref = jmapping.run_local_ba(mj, jnp.asarray(5), "pinhole", K4, bank=bj, **kw)
    got = tmapping.run_local_ba(mt, 5, "pinhole", _t(K4), bank=bt, **kw)
    _close(got.kf_R, ref.kf_R, 1e-4)
    _close(got.kf_t, ref.kf_t, 1e-4)
    _close(got.pt_xyz, ref.pt_xyz, 1e-3 * 8)
    assert np.abs(np.asarray(ref.kf_t) - np.asarray(mj.kf_t)).max() > 1e-3   # it moved
    _fields_equal(got, ref, skip=("kf_R", "kf_t", "pt_xyz"))
    # over a mesh of 8 shards the window goes to the COO gather and the
    # sharded solver in both (JAX on its 8 virtual devices, the port's 8
    # local shards): the same tolerances.  With 2048 observation slots no
    # shard of JAX's overflows, so both solve every observation (the port
    # deals the points over the shards first; test_torch_engine_mesh.py has
    # the case where JAX's shards overflow)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("shard",))
    jprob = jmapping.gather_window_problem_bank(mj, bj, jnp.asarray(5), 8, 4, 1.2, cap_cams=8,
                                                cap_pts=256, cap_obs=2048)[0]
    assert int(jdist.partition_problem(jprob, 8).obs_valid.sum()) == int(jprob.obs_valid.sum())
    ref = jmapping.run_local_ba(mj, jnp.asarray(5), "pinhole", K4, bank=bj, mesh=jmesh,
                                cap_obs=2048, **kw)
    got = tmapping.run_local_ba(mt, 5, "pinhole", _t(K4), bank=bt, mesh=multihost.Mesh(8),
                                cap_obs=2048, **kw)
    _close(got.kf_R, ref.kf_R, 1e-4)
    _close(got.kf_t, ref.kf_t, 1e-4)
    _close(got.pt_xyz, ref.pt_xyz, 1e-3 * 8)
    assert np.abs(np.asarray(ref.kf_t) - np.asarray(mj.kf_t)).max() > 1e-3   # it moved
    # position priors route the window to the COO solver, as in JAX: the
    # same poses within 1e-4 and points within 1e-3 of their scale
    K = mj.kf_R.shape[0]
    pp = np.asarray(-np.einsum("kji,kj->ki", np.asarray(mj.kf_R), np.asarray(mj.kf_t)))
    pp = (pp + np.random.default_rng(4).normal(0, 0.1, pp.shape)).astype(np.float32)
    pw = np.full(K, 100.0, np.float32)
    ref = jmapping.run_local_ba(mj, jnp.asarray(5), "pinhole", K4, bank=bj,
                                prior_pos=jnp.asarray(pp), prior_w=jnp.asarray(pw), **kw)
    got = tmapping.run_local_ba(mt, 5, "pinhole", _t(K4), bank=bt, prior_pos=_t(pp),
                                prior_w=_t(pw), **kw)
    _close(got.kf_R, ref.kf_R, 1e-4)
    _close(got.kf_t, ref.kf_t, 1e-4)
    _close(got.pt_xyz, ref.pt_xyz, 1e-3 * 8)


# ------------------------------------------------------------- feature bank
def test_feature_bank_matches_jax(kf_map):
    _, bj, ffs, binds = kf_map
    bt = convert.bank_from_numpy(H.fields(bj))
    _fields_equal(bt, bj)
    fft = convert.frame_from_numpy(H.fields(ffs[2]))
    kp = binds[2].copy()
    kp[::3] = -1
    refb = jbank.set_binding(jbank.set_frame(bj, 7, ffs[2], jnp.asarray(binds[2])), 1,
                             jnp.asarray(kp))
    gotb = tbank.set_binding(tbank.set_frame(bt, torch.tensor(7, dtype=torch.int32),
                                             fft, _t(binds[2])), 1, _t(kp))
    _fields_equal(gotb, refb)
    _fields_equal(bt, bj)                       # the input bank is untouched
    for a, b in zip(tbank.frame_view(gotb, 7), jbank.frame_view(refb, 7)):
        _equal(a, b)
    # a full map's keyframe index is the capacity: the write drops and the
    # read clamps to the last row, in both packages
    K = bj.xy.shape[0]
    _fields_equal(tbank.set_frame(bt, torch.tensor(K), fft, _t(binds[2])),
                  jbank.set_frame(bj, K, ffs[2], jnp.asarray(binds[2])))
    for a, b in zip(tbank.frame_view(gotb, torch.tensor(K)), jbank.frame_view(refb, K)):
        _equal(a, b)
    _fields_equal(tbank.empty_bank(3, 5), jbank.empty_bank(3, 5))


# --------------------------------------------------- point culling, compaction
def test_cull_points_and_compact_match_jax(kf_map):
    mj, bj, _, binds = kf_map
    rng = np.random.default_rng(10)
    P = mj.pt_xyz.shape[0]
    mj = mj._replace(
        pt_found=jnp.asarray(rng.integers(0, 5, P), jnp.int32),
        pt_visible=jnp.asarray(rng.integers(0, 9, P), jnp.int32),
        pt_first_frame=jnp.asarray(rng.integers(-300, 30, P), jnp.int32),
        obs_valid=mj.obs_valid & jnp.asarray(rng.random(mj.obs_valid.shape[0]) < 0.9))
    mt = convert.map_from_numpy(H.fields(mj))
    _equal(tstate.point_obs_count(mt), jstate.point_obs_count(mj))
    _fields_equal(tstate.rebuild_incidence(mt), jstate.rebuild_incidence(mj))
    cj = jstate.cull_points(mj, 30)
    ct = tstate.cull_points(mt, 30)
    _fields_equal(ct, cj)
    assert 0 < int(cj.pt_valid.sum()) < int(mj.pt_valid.sum())
    (kj, rj), (kt, rt) = jstate.compact(cj), tstate.compact(ct)
    _fields_equal(kt, kj)
    _equal(rt, rj)
    from orbslam3_tpu_torch.pipeline import system as tsys
    kp = np.asarray(bj.kp_pt)
    _equal(tsys.remap_bindings(_t(kp), rt),
           np.where(kp >= 0, np.asarray(rj)[np.clip(kp, 0, P - 1)], -1))


# ------------------------------------------------------------------- fusion
def test_fuse_into_keyframe_matches_jax(kf_map):
    """Keyframe 4's bindings half cleared and half pointed at duplicate
    points (new observations, merges both ways); one valid point has an
    inf max distance (T11)."""
    mj, _, ffs, binds = kf_map
    rng = np.random.default_rng(11)
    n = int(mj.n_pt)
    kp = binds[4].copy()
    bound = np.nonzero(kp >= 0)[0]
    kp[bound[::2]] = -1
    # duplicates of some bound points, bound to their keypoints in KF 4
    src = kp[bound[1::4]]
    dX = np.asarray(mj.pt_xyz)[src] + 0.002
    mj, dup = jstate.add_points(mj, jnp.asarray(dX), mj.pt_desc[src], jnp.zeros_like(dX),
                                mj.pt_min_dist[src], mj.pt_max_dist[src], 4, 24,
                                jnp.ones(len(src), bool))
    kp[bound[1::4]] = np.asarray(dup)
    mj = jstate.add_observations(mj, 4, dup, ffs[4].xy[bound[1::4]],
                                 ffs[4].octave[bound[1::4]], jnp.ones(len(src), bool))
    mj = mj._replace(pt_max_dist=mj.pt_max_dist.at[n - 1].set(jnp.inf))
    mt = convert.map_from_numpy(H.fields(mj))
    fft = convert.frame_from_numpy(H.fields(ffs[4]))
    ref = jfusion.fuse_into_keyframe(mj, 4, ffs[4], jnp.asarray(kp), "pinhole", K4, HW,
                                     1.2, 4)
    got = tfusion.fuse_into_keyframe(mt, 4, fft, _t(kp), "pinhole", _t(K4), HW, 1.2, 4)
    _fields_equal(got[0], ref[0])
    _equal(got[1], ref[1])
    assert int(got[2]) == int(ref[2]) > 0
    assert (np.asarray(ref[1]) >= 0).sum() > (kp >= 0).sum()


def test_redundancy_and_cull_keyframe_match_jax(kf_map):
    mj = kf_map[0]
    mt = convert.map_from_numpy(H.fields(mj))
    for k in range(6):
        rj, fj = jfusion.keyframe_redundancy(mj, k)
        rt, ft = tfusion.keyframe_redundancy(mt, k)
        assert bool(rt) == bool(rj)
        assert float(ft) == float(fj)
    for center in (5, 7):
        for th in (0.9, 0.5):
            _equal(tfusion.redundancy_window(mt, center, redundant_th=th),
                   jfusion.redundancy_window(mj, center, redundant_th=th))
    assert np.asarray(jfusion.redundancy_window(mj, 7, redundant_th=0.5)).any()
    _fields_equal(tfusion.cull_keyframe(mt, 2), jfusion.cull_keyframe(mj, 2))


def test_refresh_point_descriptors_matches_jax(kf_map):
    """Pushes into the reservoir rings past their depth; keyframe 3 binds
    one point twice (T13: its slot keeps the later keypoint's descriptor,
    its count grows by two)."""
    mj, _, ffs, binds = kf_map
    mt = convert.map_from_numpy(H.fields(mj))
    rng = np.random.default_rng(12)
    for rep in range(10):
        k = [3, 1, 3, 2, 3, 0, 4, 3, 5, 3][rep]
        ff = ffs[k]._replace(desc=jnp.asarray(np.asarray(ffs[k].desc) ^ rng.integers(
            0, 2, (N_KP, 8)).astype(np.uint32) << np.uint32(rep)))
        mj = jfusion.refresh_point_descriptors(mj, ff, jnp.asarray(binds[k]))
        mt = tfusion.refresh_point_descriptors(mt, convert.frame_from_numpy(H.fields(ff)),
                                               _t(binds[k]))
        _fields_equal(mt, mj)
    dup = int(binds[3][0])
    assert int(mj.pt_desc_n[dup]) >= 2 * 5
