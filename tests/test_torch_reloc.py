"""Relocalization of the port against the JAX package: the SVD projection
onto SO(3), MLPnP piece by piece and whole, the relocalization batch on a
JAX-built map and bank, and both `System`s recovering a kidnapped frame.

RANSAC samples: the JAX functions draw theirs from a key; the tests compute
the same draw (`torch_parity_helpers.jax_mlpnp_samples`,
`jax_reloc_samples`) and inject it into the port, whose own draw comes from
a `torch.Generator`.  One JAX `System` (with its 65536-word keyframe
database, the default) boots once per file and feeds the batch test and the
System-level test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.geometry import mlpnp as jmlpnp
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import relocalization as jreloc
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.geometry import mlpnp as tmlpnp
from orbslam3_tpu_torch.ops import lie as tlie
from orbslam3_tpu_torch.pipeline import relocalization as treloc
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.place import keyframe_db as tkdb
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- pieces ---------------------------------------------------------------------

def test_normalize_rotation_svd_matches_jax():
    """Raw 3x3 matrices, reflected ones among them: a rotation within 1e-5 of
    JAX's (the SVD's singular vectors may differ in sign, the product does
    not)."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    M[:8] = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(size=(8, 3)), jnp.float32))) * 2.5
    M[8:16] *= np.array([1, 1, -1], np.float32)                   # reflections
    ref = np.asarray(jlie.normalize_rotation_svd(jnp.asarray(M)))
    got = tlie.normalize_rotation_svd(_t(M)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    np.testing.assert_allclose(tlie.det3(_t(M)).numpy(), np.linalg.det(M), rtol=1e-4, atol=1e-5)


def test_bearing_nullspace_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(200, 3)).astype(np.float32)
    v[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0.3, 0.3, 0.9055]]   # both axis choices
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    ref = np.asarray(jmlpnp.bearing_nullspace(jnp.asarray(v)))
    got = tmlpnp.bearing_nullspace(_t(v)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(np.einsum("nij,ni->nj", got, v), 0.0, atol=1e-6)
    # a leading batch dimension gives the same
    np.testing.assert_array_equal(tmlpnp.bearing_nullspace(_t(v).reshape(4, 50, 3)).numpy(),
                                  got.reshape(4, 50, 3, 2))


def test_fix_pose_matches_jax_and_removes_the_sign():
    """R within 1e-5 and t within 1e-5 relative of JAX's; [-M | -t] gives
    the same pose as [M | t]."""
    rng = np.random.default_rng(2)
    M = rng.normal(size=(32, 3, 3)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    Rj, tj = jax.vmap(jmlpnp._fix_pose)(jnp.asarray(M), jnp.asarray(t))
    Rt, tt = tmlpnp._fix_pose(_t(M), _t(t))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5, atol=1e-5)
    Rn, tn = tmlpnp._fix_pose(-_t(M), -_t(t))
    np.testing.assert_allclose(Rn.numpy(), Rt.numpy(), atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), tt.numpy(), rtol=1e-5, atol=1e-5)


def _scene(seed, planar, n=300, outliers=0.3, noise=0.5):
    """n world points (a tilted plane or a cloud), seen from a known pose
    with octave noise, `outliers` of them moved anywhere in the image."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  np.full(n, 6.0) if planar else rng.uniform(4, 9, n)], 1)
    if planar:
        Rp = np.asarray(jlie.exp_so3(jnp.array([0.2, -0.1, 0.05])), np.float64)
        X = (X - [0, 0, 6]) @ Rp.T + [0, 0, 6]
    R = np.asarray(jlie.exp_so3(jnp.array([0.05, -0.1, 0.03])), np.float64)
    t = np.array([0.3, -0.2, 0.5])
    Xc = X @ R.T + t
    uv = np.stack([K4[0] * Xc[:, 0] / Xc[:, 2] + K4[2], K4[1] * Xc[:, 1] / Xc[:, 2] + K4[3]], 1)
    sigma = 1.2 ** rng.integers(0, 4, n)
    uv += rng.standard_normal((n, 2)) * sigma[:, None] * noise
    bad = rng.random(n) < outliers
    uv[bad] = np.stack([rng.uniform(0, HW[1], bad.sum()), rng.uniform(0, HW[0], bad.sum())], 1)
    valid = rng.random(n) > 0.1
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(X), f32(uv), valid, f32(1 / sigma ** 2), f32(R), f32(t), bad


def _sample_sets(X, uv, n_sets, rng, size=6):
    v = np.concatenate([(uv - K4[2:]) / K4[:2], np.ones((len(uv), 1))], 1).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    J = np.asarray(jmlpnp.bearing_nullspace(jnp.asarray(v)))
    idx = np.stack([rng.permutation(len(X))[:size] for _ in range(n_sets)])
    return X[idx], J[idx]


def test_solve_general_matches_jax_on_a_cloud():
    """Noise-free 12-point samples of a non-planar cloud (a minimal 6-point
    sample's 12x12 Gram matrix is often too ill-conditioned in float32 for
    two eigensolvers to agree on its null vector): both libraries find the
    true pose, R within 1e-3 of each other and t within 5e-3 (the float32 Gram
    matrix squares the design matrix's condition number, and each side's t is
    itself up to 3e-3 from the truth; the eigenvector's sign is removed by
    `_fix_pose`)."""
    X, uv, _, _, R, t, _ = _scene(3, planar=False, outliers=0.0, noise=0.0)
    Xs, Js = _sample_sets(X, uv, 24, np.random.default_rng(3), size=12)
    Rj, tj = jax.vmap(jmlpnp._solve_general)(jnp.asarray(Xs), jnp.asarray(Js))
    Rt, tt = tmlpnp._solve_general(_t(Xs), _t(Js))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-3)
    np.testing.assert_allclose(tt.numpy(), np.broadcast_to(t, (24, 3)), atol=5e-3)
    assert np.abs(Rt.numpy() - R).max() < 2e-3


def test_solve_planar_matches_jax_up_to_the_mirror():
    """Noise-free samples on a plane.  The planar form does not remove the
    eigenvector's sign: u and -u give a pose and its mirror image (every
    point behind its bearing).  Each sample's pose must be JAX's or its
    mirror (R diag(-1, -1, 1) in the plane basis, -t about the centroid),
    compared through what the solver is scored on: the camera-frame points
    agree, or are each other's negatives, within 1e-3 of the depth."""
    X, uv, valid, _, R, t, _ = _scene(4, planar=True, outliers=0.0, noise=0.0)
    Xs, Js = _sample_sets(X, uv, 24, np.random.default_rng(4))
    c = X.mean(0)
    evals, E = np.linalg.eigh((X - c).T @ (X - c) / len(X))
    E_plane = np.stack([E[:, 2], E[:, 1], E[:, 0]], 1).astype(np.float32)
    Rj, tj = jax.vmap(lambda a, b: jmlpnp._solve_planar(a, b, jnp.asarray(E_plane),
                                                        jnp.asarray(c)))(
        jnp.asarray(Xs), jnp.asarray(Js))
    Rt, tt = tmlpnp._solve_planar(_t(Xs), _t(Js), _t(E_plane), _t(c))
    Xc_j = np.einsum("sij,nj->sni", np.asarray(Rj), X) + np.asarray(tj)[:, None]
    Xc_t = np.einsum("sij,nj->sni", Rt.numpy(), X) + tt.numpy()[:, None]
    same = np.abs(Xc_t - Xc_j).max(axis=(1, 2))
    mirrored = np.abs(Xc_t + Xc_j).max(axis=(1, 2))
    assert (np.minimum(same, mirrored) < 1e-3 * 6.0).all()
    # and either is the true pose or its mirror
    Xc = X @ R.T + t
    err = np.minimum(np.abs(Xc_t - Xc).max(axis=(1, 2)), np.abs(Xc_t + Xc).max(axis=(1, 2)))
    assert np.median(err) < 5e-2


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_mlpnp_matches_jax_with_its_samples(planar, seed):
    """30% outliers, octave noise, 300 hypotheses from JAX's own draw: the
    same inlier set, R within 1e-4, t within 1e-3 relative, and the pose is
    the true one.  On the plane the select on `planar` must keep the general
    form's arbitrary result out."""
    X, uv, valid, is2, R, t, bad = _scene(seed, planar)
    key = jax.random.PRNGKey(seed)
    rj = jmlpnp.solve_mlpnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), "pinhole", K4,
                            key, iterations=300, inv_sigma2=jnp.asarray(is2))
    idx = H.jax_mlpnp_samples(key, valid, is2, 300)
    rt = tmlpnp.solve_mlpnp(_t(X), _t(uv), _t(valid), "pinhole", K4, idx=_t(idx),
                            iterations=300, inv_sigma2=_t(is2))
    assert bool(rt.success) and bool(rj.success)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 150
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t),
                               atol=1e-3 * float(np.linalg.norm(t)))
    np.testing.assert_allclose(rt.R.numpy(), R, atol=5e-3)
    assert not rt.inliers.numpy()[bad & valid].mean() > 0.05      # outliers stay out
    assert all(torch.isfinite(x.to(torch.float32)).all() for x in rt)


def test_solve_mlpnp_returns_a_rotation_where_jax_returns_a_reflection():
    """The port's one deliberate difference (see `geometry/mlpnp.py`): on
    this plane LAPACK's `eigh` hands the JAX package a left-handed plane
    basis, and its planar form then returns the true pose times the
    reflection through the plane, det(R) = -1, with every inlier.  The port
    makes the basis right-handed: the same inliers, and the true rotation."""
    X, uv, valid, is2, R, t, _ = _scene(3, planar=True)
    key = jax.random.PRNGKey(3)
    rj = jmlpnp.solve_mlpnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), "pinhole", K4,
                            key, iterations=300, inv_sigma2=jnp.asarray(is2))
    rt = tmlpnp.solve_mlpnp(_t(X), _t(uv), _t(valid), "pinhole", K4,
                            idx=_t(H.jax_mlpnp_samples(key, valid, is2, 300)),
                            iterations=300, inv_sigma2=_t(is2))
    assert np.linalg.det(np.asarray(rj.R)) == pytest.approx(-1.0, abs=1e-4)
    assert np.linalg.det(rt.R.numpy()) == pytest.approx(1.0, abs=1e-4)
    np.testing.assert_allclose(rt.R.numpy(), R, atol=5e-3)
    np.testing.assert_allclose(rt.t.numpy(), t, atol=5e-2)
    assert bool(rt.success) and abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1
    # JAX's matrix maps the plane's points where the port's rotation does
    on = valid & np.asarray(rj.inliers)
    Xj = X[on] @ np.asarray(rj.R).T + np.asarray(rj.t)
    Xt = X[on] @ rt.R.numpy().T + rt.t.numpy()
    assert np.abs(Xj - Xt).max() < 2e-2


def test_solve_mlpnp_batch_equals_its_problems_one_by_one():
    """A planar and a non-planar problem in one batch: every field equal to
    the two single calls' (the select on `planar` is per problem), within
    1e-6 (batched matrix products may sum in another order)."""
    scenes = [_scene(5, planar=True), _scene(6, planar=False)]
    idx = [H.jax_mlpnp_samples(jax.random.PRNGKey(7 + i), s[2], s[3], 64)
           for i, s in enumerate(scenes)]
    single = [tmlpnp.solve_mlpnp(_t(s[0]), _t(s[1]), _t(s[2]), "pinhole", K4, idx=_t(i),
                                 iterations=64, inv_sigma2=_t(s[3]))
              for s, i in zip(scenes, idx)]
    stack = lambda k: torch.stack([_t(s[k]) for s in scenes])
    both = tmlpnp.solve_mlpnp(stack(0), stack(1), stack(2), "pinhole", K4,
                              idx=torch.stack([_t(i) for i in idx]), iterations=64,
                              inv_sigma2=stack(3))
    assert both.R.shape == (2, 3, 3) and both.inliers.shape == (2, 300)
    for b, one in enumerate(single):
        assert int(both.n_inliers[b]) == int(one.n_inliers)
        np.testing.assert_array_equal(both.inliers[b].numpy(), one.inliers.numpy())
        np.testing.assert_allclose(both.R[b].numpy(), one.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(both.t[b].numpy(), one.t.numpy(), atol=1e-6)


def test_solve_mlpnp_draws_its_own_samples_from_a_generator():
    """Without `idx` the port draws with `torch.multinomial` from an explicit
    generator: reproducible for one seed, the true pose for any."""
    X, uv, valid, is2, R, t, _ = _scene(8, planar=True)
    args = (_t(X), _t(uv), _t(valid), "pinhole", K4)
    runs = []
    for seed in (1, 1, 2):
        g = torch.Generator().manual_seed(seed)
        runs.append(tmlpnp.solve_mlpnp(*args, generator=g, iterations=300, inv_sigma2=_t(is2)))
    assert torch.equal(runs[0].R, runs[1].R) and torch.equal(runs[0].inliers, runs[1].inliers)
    for r in runs:
        assert bool(r.success)
        np.testing.assert_allclose(r.R.numpy(), R, atol=5e-3)
        np.testing.assert_allclose(r.t.numpy(), t, atol=5e-2)
    # nothing valid: no success, finite output
    none = tmlpnp.solve_mlpnp(_t(X), _t(uv), torch.zeros(300, dtype=torch.bool), "pinhole", K4,
                              generator=torch.Generator().manual_seed(0), iterations=32)
    assert not bool(none.success) and int(none.n_inliers) == 0


def test_admitted_candidates_follow_the_reference_rule():
    """Every keyframe at or above 0.75 of the best score, the best first,
    not only the top 3; dead keyframes and a database without a positive
    score admit nothing."""
    s = np.array([0.5, 0.9, 1.0, -1.0, 0.76, 0.8, 0.74], np.float32)
    alive = np.ones(7, bool)
    assert treloc.admitted_candidates(s, alive) == [2, 1, 5, 4]
    alive[1] = False
    assert treloc.admitted_candidates(s, alive) == [2, 5, 4]
    assert treloc.admitted_candidates(np.full(4, -1.0, np.float32), np.ones(4, bool)) == []


# --- on a JAX-built map ---------------------------------------------------------

CAP = dict(n_kf=32, n_pt=4096, n_obs=32768)
COMMON = dict(cam_params=K4, image_hw=HW, min_init_matches=80, local_view_points=2048,
              ba_caps=(16, 2048, 8192), new_pt_budget=256, max_frames_between_kf=6,
              reloc_patience=12)
DT = 0.05
N_BOOT = 31


def _jff(f):
    return jsystem.FeatureFrame(**{k: jnp.asarray(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def booted():
    """A JAX `System` with the default keyframe database, fed `N_BOOT` frames
    of a synthetic world; and the world's later frames, drawn once."""
    world = SyntheticWorld(seed=7)
    poses = camera_path(N_BOOT)
    jsys = jsystem.System(jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **COMMON))
    assert jsys.loop_closer is not None
    for i, (R, t, _) in enumerate(poses):
        jsys.track_monocular(None, ts=i * DT, features=world.frame(R, t))
    assert jsys.state == jsystem.OK and jsys.n_kf_host >= 5 and jsys.n_resets == 0
    # a kidnap back to the path's start (frames 3-8 again, fresh noise), and
    # one query frame for the batch test
    revisit = [H.fields(world.frame(*poses[i][:2])) for i in range(3, 9)]
    snapshot = dict(map=jsys.map, bank=jsys.bank, db=jsys.loop_closer.db,
                    n_kf=jsys.n_kf_host)
    return jsys, snapshot, revisit


def test_system_feeds_the_database_at_every_keyframe(booted):
    jsys, snap, _ = booted
    active = np.asarray(snap["db"].active)
    valid = np.asarray(snap["map"].kf_valid)
    assert active[:snap["n_kf"]].sum() >= 5
    np.testing.assert_array_equal(active, valid)     # culled keyframes are erased


def test_reloc_batch_matches_jax_on_its_map_and_bank(booted):
    """The JAX system's map and bank, a frame from a place seen earlier, the
    first 6 keyframes and two empty slots as candidates, JAX's samples
    injected: the same `good` flags, the same winner, inlier counts within 1,
    the winner's pose within 1e-4 / 1e-3 relative."""
    jsys, snap, revisit = booted
    m, bank = snap["map"], snap["bank"]
    ffj = _jff(revisit[2])
    cand_idx = np.array([0, 1, 2, 3, 4, 5, 0, 0], np.int32)
    cand_ok = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    key = jax.random.PRNGKey(123)
    cam = jnp.asarray(K4, jnp.float32)
    gj, nj, Rj, tj = jreloc._reloc_batch(m, bank, ffj, jnp.asarray(cand_idx), jnp.asarray(cand_ok),
                                         key, cam, "pinhole", 1.2, 8, 30)
    idx = H.jax_reloc_samples(m, bank, ffj, cand_idx, cand_ok, key, 1.2, 8)
    assert idx.shape == (8, 300, 6)
    gt, nt, Rt, tt = treloc._reloc_batch(
        convert.map_from_numpy(H.fields(m)), convert.bank_from_numpy(H.fields(bank)),
        convert.frame_from_numpy(revisit[2]), _t(cand_idx), _t(cand_ok),
        torch.tensor(K4), "pinhole", 1.2, 8, 30, idx=_t(idx))
    gj, nj = np.asarray(gj), np.asarray(nj)
    np.testing.assert_array_equal(gt.numpy(), gj)
    assert gj[:6].any() and not gj[6:].any()
    assert np.abs(nt.numpy() - nj).max() <= 1
    wj = int(np.argmax(np.where(gj, nj, -1)))
    assert int(np.argmax(np.where(gt.numpy(), nt.numpy(), -1))) == wj
    np.testing.assert_allclose(Rt[wj].numpy(), np.asarray(Rj[wj]), atol=1e-4)
    np.testing.assert_allclose(tt[wj].numpy(), np.asarray(tj[wj]),
                               atol=1e-3 * float(np.linalg.norm(np.asarray(tj[wj]))))


def _blank(n):
    f = dict(xy=np.zeros((n, 2), np.float32), response=np.zeros(n, np.float32),
             octave=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
             desc=np.zeros((n, 8), np.uint32), valid=np.zeros(n, bool))
    return f


def test_both_systems_recover_a_kidnapped_frame_by_relocalization(booted, monkeypatch):
    """In the manner of the JAX package's `test_recover_after_occlusion`,
    with a kidnap: the port continues from a copy of the JAX system's state
    and keyframe database; both see 3 frames without keypoints (RECENTLY_LOST,
    nothing recovered), then a frame from the start of the path, 1.4 units
    behind the last pose, which local-map tracking from the last pose cannot
    find, then the frames after it.  Both recover on the kidnapped frame
    through relocalization, with no reset and no new map.  The port's attempt
    is given the RANSAC samples that the JAX attempt drew (its key is
    `PRNGKey(frame_id + lo)`, split per candidate), so on the kidnapped frame
    the poses agree as the batch test's do: the camera centre within 1e-3 of
    the map's unit (median depth 1) and every entry of the rotation within
    1e-4 (float32 cannot resolve an angle below 0.03 degrees through the
    trace).  The frames after it are tracked against the same map and agree
    within 2e-3 and 0.05 degrees."""
    jsys, snap, revisit = booted
    tsys = tsystem.System(tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **COMMON),
                          device="cpu")
    assert tsys.loop_closer is not None
    H.copy_system_state(jsys, tsys)
    H.copy_keyframe_db(jsys, tsys)
    attempts = []                       # what each JAX attempt saw

    def jax_attempt(system, ff, loop_closer, **kw):
        attempts.append((system.map, system.bank, ff, system.frame_id))
        return jax_attempt_fn(system, ff, loop_closer, **kw)

    def port_attempt(system, ff, loop_closer, **kw):
        m, bank, ffj, frame_id = attempts[-1]
        assert frame_id == system.frame_id

        def jax_draw(lo, cand_idx, cand_ok):
            return _t(H.jax_reloc_samples(
                m, bank, ffj, cand_idx.numpy(), cand_ok.numpy(),
                jax.random.PRNGKey(frame_id + lo), system.cfg.orb.scale_factor,
                system.cfg.orb.n_levels))
        return port_attempt_fn(system, ff, loop_closer, idx_fn=jax_draw, **kw)

    jax_attempt_fn, port_attempt_fn = (jreloc.attempt_relocalization,
                                       treloc.attempt_relocalization)
    monkeypatch.setattr(jreloc, "attempt_relocalization", jax_attempt)
    monkeypatch.setattr(treloc, "attempt_relocalization", port_attempt)
    i = N_BOOT
    n = revisit[0]["xy"].shape[0]
    for _ in range(3):
        sj, _ = jsys.track_monocular(None, ts=i * DT, features=_jff(_blank(n)))
        st, _ = tsys.track_monocular(None, ts=i * DT, features=convert.frame_from_numpy(_blank(n)))
        assert sj == st == tsystem.RECENTLY_LOST
        i += 1
    assert tsys.lost_frames == jsys.lost_frames == 3
    for k, f in enumerate(revisit[:5]):
        sj, pj = jsys.track_monocular(None, ts=i * DT, features=_jff(f))
        st, pt = tsys.track_monocular(None, ts=i * DT, features=convert.frame_from_numpy(f))
        assert sj == st == tsystem.OK, k
        assert np.linalg.norm(pt[1] - pj[1]) < (1e-3 if k == 0 else 2e-3), k
        cos = (np.trace(pt[0] @ pj[0].T) - 1.0) / 2.0
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.05, k
        if k == 0:
            np.testing.assert_allclose(pt[0], pj[0], atol=1e-4)
            # tracking from the last pose failed on both: relocalization did it
            assert len(attempts) == 4           # 3 on the blank frames, this one
            assert tsys.last_track_inliers < tsys.cfg.min_track_inliers
            assert jsys.last_track_inliers < jsys.cfg.min_track_inliers
            assert tsys.lost_frames == 0 and not tsys.has_velocity
        i += 1
    assert tsys.n_resets == jsys.n_resets == 0
    assert tsys.atlas.n_maps == jsys.atlas.n_maps == 0
    assert tsys.n_kf_host == jsys.n_kf_host            # the same keyframes since
    np.testing.assert_array_equal(tsys.loop_closer.db.active.numpy(),
                                  np.asarray(jsys.loop_closer.db.active))


# --- the port's own wiring --------------------------------------------------------

def _port_with_copied_state(booted, **kw):
    jsys, snap, _ = booted
    tsys = tsystem.System(tsystem.SlamConfig(map_capacity=MapCapacity(**CAP),
                                             **{**COMMON, **kw}), device="cpu")
    tsys.map = convert.map_from_numpy(H.fields(snap["map"]))
    tsys.bank = convert.bank_from_numpy(H.fields(snap["bank"]))
    tsys.loop_closer.db = convert.db_from_numpy(H.fields(snap["db"]))
    tsys.n_kf_host = snap["n_kf"]
    tsys.state = tsystem.OK
    return tsys


def test_database_is_archived_with_the_atlas_session(booted):
    tsys = _port_with_copied_state(booted)
    db = tsys.loop_closer.db
    tsys.loop_closer.consistent_groups = [(np.zeros(32, bool), 1)]
    tsys.trajectory = [(0.0, np.eye(3), np.zeros(3))]
    tsys._reset()
    assert tsys.atlas.n_maps == 1 and tsys.n_resets == 1
    assert tsys.atlas.sessions[0].db is db and bool(db.active.any())
    assert not bool(tsys.loop_closer.db.active.any())
    assert not bool(tsys.loop_closer.db.tf.any())
    assert tsys.loop_closer.db.tf.shape == db.tf.shape
    assert tsys.loop_closer.consistent_groups == []


def test_culled_keyframe_is_erased_from_the_database(booted, monkeypatch):
    """`post_ba_stages` with keyframe culling due and a redundant keyframe:
    the keyframe goes from the map and from the database, keyframe `ki` is
    registered, and a database query can no longer return the culled one."""
    from orbslam3_tpu_torch.pipeline import fusion
    tsys = _port_with_copied_state(booted)
    _, snap, revisit = booted
    ki = 8
    assert snap["n_kf"] <= ki < CAP["n_kf"]
    gone = 2
    assert bool(tsys.loop_closer.db.active[gone])
    flags = torch.zeros(CAP["n_kf"], dtype=torch.bool)
    flags[gone] = True
    monkeypatch.setattr(fusion, "redundancy_window", lambda m, k: flags)
    ff = convert.frame_from_numpy(revisit[0])
    kp_pt = torch.full((ff.xy.shape[0],), -1, dtype=torch.int32)
    cfg = dataclasses.replace(tsys.cfg, fuse_every_n_kf=0)
    m, bank, _, _ = tsystem.post_ba_stages(cfg, tsys.cam_params, tsys.map, tsys.bank, ki, ff,
                                           kp_pt, None, loop_closer=tsys.loop_closer)
    db = tsys.loop_closer.db
    assert not bool(m.kf_valid[gone]) and not bool(db.active[gone])
    assert not bool(db.tf[gone].any()) and not bool(db.has_word[gone].any())
    assert bool(db.active[ki]) and float(db.tf[ki].sum()) == pytest.approx(1.0, abs=1e-5)
    bow, _ = tsys.loop_closer._bow(tsys.bank.desc[gone], tsys.bank.valid[gone])
    scores, _ = tkdb.query(db, bow)
    assert float(scores[gone]) == -1.0
    # without a loop closer the stage leaves every database alone
    tsystem.post_ba_stages(cfg, tsys.cam_params, tsys.map, tsys.bank, ki, ff, kp_pt, None)


# --- the DLT solver ---------------------------------------------------------------

@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.3), (2, 0.45)])
def test_solve_pnp_matches_jax_with_its_samples(seed, outliers):
    """`geometry/pnp.solve_pnp` with JAX's two sample sets (one key split in
    two, pnp.py:112-118) injected: the winning hypothesis and the refinement
    agree, the same inlier set but for at most 1 point on the chi2 line, R
    within 1e-4, t within 1e-3 relative, and the pose is the true one."""
    from orbslam3_tpu.geometry import pnp as jpnp
    from orbslam3_tpu_torch.geometry import pnp as tpnp
    X, uv, valid, is2, R, t, bad = _scene(seed, planar=False, outliers=outliers)
    key = jax.random.PRNGKey(10 + seed)
    rj = jpnp.solve_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), "pinhole", K4, key,
                        iterations=300, inv_sigma2=jnp.asarray(is2))
    logw = jnp.log(jnp.asarray(valid).astype(jnp.float32) + 1e-9)
    idx = [np.asarray(jax.random.categorical(k, logw[None, :].repeat(sets * pts, 0))
                      .reshape(sets, pts))
           for k, (sets, pts) in zip(jax.random.split(key), tpnp.sample_sizes(300, 12))]
    assert [i.shape for i in idx] == [(150, 12), (150, 7)]
    rt = tpnp.solve_pnp(_t(X), _t(uv), _t(valid), "pinhole", K4, idx=[_t(i) for i in idx],
                        iterations=300, inv_sigma2=_t(is2))
    assert bool(rt.success) and bool(rj.success)
    assert (rt.inliers.numpy() != np.asarray(rj.inliers)).sum() <= 1
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t),
                               atol=1e-3 * float(np.linalg.norm(t)))
    np.testing.assert_allclose(rt.R.numpy(), R, atol=5e-3)
    # its own draw, from a generator: the true pose too
    own = tpnp.solve_pnp(_t(X), _t(uv), _t(valid), "pinhole", K4,
                         generator=torch.Generator().manual_seed(seed), iterations=300,
                         inv_sigma2=_t(is2))
    assert bool(own.success)
    np.testing.assert_allclose(own.R.numpy(), R, atol=5e-3)
