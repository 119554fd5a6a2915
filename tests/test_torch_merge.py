"""The port's multi-session Atlas against the JAX package's: the Sim3 weld of
one map into another (`atlas.transform_map`, `merge_maps`), the splice of
the two feature banks that stands for JAX's remap of its host dictionaries,
`map_merging.try_merge` on `tests/test_map_merge.py`'s hand-built two-session
scene with JAX's RANSAC samples injected, and the port's own 80-frame drive
that loses its track, starts a second map and welds it into the first on the
revisit, held to `test_sessions_weld_on_revisit`'s gates.  Each test states
its tolerance.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.features.extractor import FeatureFrame as JFeatureFrame
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import inertial_system as jis
from orbslam3_tpu.pipeline import map_merging as jmerge
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.place import keyframe_db as jkdb
from orbslam3_tpu.slam_map import atlas as jatlas
from orbslam3_tpu.slam_map import feature_bank as jbank
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import map_merging as tmerge
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import atlas as tatlas
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.utils import align as talign
from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path
from test_torch_gba import CAP, N_KF, N_PT, N_KP, _jax_map
from test_torch_loop import _jax_draw

torch.set_num_threads(2)

INT_KINDS = "biu"


def _fields_close(got: dict, ref: dict, atol: float = 1e-5, skip=()):
    """Integer and boolean fields equal, float fields within `atol`."""
    for name, r in ref.items():
        if name in skip:
            continue
        g, r = np.asarray(got[name]), np.asarray(r)
        if r.dtype == np.uint32:
            r = r.view(np.int32)
        if r.dtype.kind in INT_KINDS:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _two_maps():
    """Two JAX maps with banks (`_jax_map`): the second carries two loop
    edges and the first one edge and a culled keyframe (3).  Made once (the
    maps are immutable)."""
    m_old, b_old = _jax_map(seed=3)
    m_new, b_new = _jax_map(seed=4)
    m_old = m_old._replace(kf_valid=m_old.kf_valid.at[3].set(False))
    m_old = jstate.add_loop_edge(m_old, 7, 0, jlie.exp_so3(jnp.asarray([0.0, 0.1, 0.0])),
                                 jnp.asarray([0.1, 0.0, 0.2]), jnp.asarray(1.0))
    for i, j in ((6, 1), (7, 2)):
        m_new = jstate.add_loop_edge(m_new, i, j, jlie.exp_so3(jnp.asarray([0.02 * i, 0, 0.1])),
                                     jnp.asarray([0.3, -0.1 * j, 0.0]), jnp.asarray(0.9))
    return m_old, b_old, m_new, b_new


SIM3 = (np.asarray(jlie.exp_so3(jnp.asarray([0.1, -0.05, 0.2]))), np.array([1.0, 2.0, -0.5]),
        1.3)


def test_transform_map_matches_jax():
    """x' = s Rg x + tg on every keyframe, point, velocity and normal: every
    field within 1e-5 of JAX's (integer fields equal)."""
    m = _two_maps()[2]
    Rg, tg, s = SIM3
    m = m._replace(kf_vel=jnp.asarray(np.random.default_rng(0).normal(
        size=m.kf_vel.shape).astype(np.float32)))
    ref = jatlas.transform_map(m, jnp.asarray(Rg, jnp.float32), jnp.asarray(tg, jnp.float32),
                               jnp.asarray(s, jnp.float32))
    got = tatlas.transform_map(convert.map_from_numpy(H.fields(m)),
                               torch.tensor(Rg, dtype=torch.float32),
                               torch.tensor(tg, dtype=torch.float32),
                               torch.tensor(s, dtype=torch.float32))
    _fields_close(convert.to_numpy(got), H.fields(ref), atol=1e-5)


def test_merge_maps_and_bank_splice_match_jax():
    """`merge_maps`: every field of the welded map as JAX's (integer fields,
    the shifted indices, the incidence and the counters equal; floats within
    1e-5), the incoming loop edges spliced with `loop_t * s`.
    `splice_banks`: the JAX System's bank after a merge, rebuilt from its
    remapped dictionaries (every non-culled keyframe's features at its new
    index, bindings shifted by the point offset), row for row."""
    m_old, b_old, m_new, b_new = _two_maps()
    Rg, tg, s = SIM3
    j_args = (jnp.asarray(Rg, jnp.float32), jnp.asarray(tg, jnp.float32),
              jnp.asarray(s, jnp.float32))
    t_args = tuple(torch.tensor(np.float32(x)) for x in (Rg, tg, s))
    cap = jstate.MapCapacity(**CAP)
    ref, kf_off, pt_off = jatlas.merge_maps(m_old, m_new, *j_args, cap)
    tm_old, tm_new = (convert.map_from_numpy(H.fields(x)) for x in (m_old, m_new))
    got, t_kf_off, t_pt_off = tatlas.merge_maps(tm_old, tm_new, *t_args, MapCapacity(**CAP))
    assert (t_kf_off, t_pt_off) == (kf_off, pt_off) == (N_KF, N_PT)
    g, r = convert.to_numpy(got), H.fields(ref)
    _fields_close(g, r, atol=1e-5)
    assert int(g["n_loop"]) == 3 and g["loop_i"][1:3].tolist() == [6 + N_KF, 7 + N_KF]

    # JAX's bank rebuild from its host dictionaries, as map_merging does it
    feats, binds = {}, {}
    for bank, off, valid in ((b_old, 0, np.asarray(m_old.kf_valid)),
                             (b_new, kf_off, np.asarray(m_new.kf_valid))):
        for k in range(N_KF):
            if not valid[k]:
                continue         # a culled keyframe is not in the dictionaries
            feats[k + off] = JFeatureFrame(xy=bank.xy[k], response=jnp.ones(N_KP),
                                           octave=bank.octave[k], angle=bank.angle[k],
                                           desc=bank.desc[k], valid=bank.valid[k])
            kp = bank.kp_pt[k]
            binds[k + off] = kp if off == 0 else jnp.where(kp >= 0, kp + pt_off, -1)
    jb = jbank.empty_bank(CAP["n_kf"], N_KP)
    for k, f in feats.items():
        jb = jbank.set_frame(jb, k, f, binds[k])
    tb = tatlas.splice_banks(convert.bank_from_numpy(H.fields(b_old)),
                             convert.bank_from_numpy(H.fields(b_new)), got.kf_valid, kf_off,
                             N_KF, pt_off)
    _fields_close(convert.to_numpy(tb), H.fields(jb), atol=0.0)


@pytest.mark.parametrize("over", ["n_kf", "n_pt", "n_obs"])
def test_merge_maps_refuses_an_overflow(over):
    """A merge that would overflow any capacity returns (None, 0, 0) in both
    packages (test_atlas_reloc's `test_merge_overflow_rejected`, one case per
    capacity)."""
    m_old, _, m_new, _ = _two_maps()
    n = dict(n_kf=2 * N_KF, n_pt=2 * N_PT, n_obs=int(m_old.n_obs) + int(m_new.n_obs))
    n[over] -= 1
    args = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.float32(1.0))
    ref = jatlas.merge_maps(m_old, m_new, *map(jnp.asarray, args), jstate.MapCapacity(**n))
    got = tatlas.merge_maps(convert.map_from_numpy(H.fields(m_old)),
                            convert.map_from_numpy(H.fields(m_new)),
                            *map(torch.from_numpy, map(np.asarray, args)), MapCapacity(**n))
    assert ref == (None, 0, 0) and got == (None, 0, 0)


# --- try_merge on TestInertialMerge's hand-built two-session scene ------------------

SCENE_CAP = dict(n_kf=32, n_pt=4096, n_obs=16384)
N_SCENE_KP = 256


def _scene(inertial: bool, **cfg_kw):
    """TestInertialMerge's scene (tests/test_map_merge.py:50-135) in both
    packages: an archived session whose keyframe 0 sees 200 points, and a
    current map whose keyframe 1 sees the same place from a rigid offset.
    `cfg_kw` go to both SlamConfigs.  Returns (JAX system, port system, the
    current keyframe's features as numpy, the current map's point indices)."""
    rng = np.random.default_rng(2)
    n_pts = 200

    def pad_ff(xy, desc):
        n = xy.shape[0]
        pad = N_SCENE_KP - n
        return dict(xy=np.concatenate([xy, np.zeros((pad, 2))]).astype(np.float32),
                    response=np.ones(N_SCENE_KP, np.float32),
                    octave=np.zeros(N_SCENE_KP, np.int32), angle=np.zeros(N_SCENE_KP, np.float32),
                    desc=np.concatenate([desc, np.zeros((pad, 8), np.uint32)]),
                    valid=np.arange(N_SCENE_KP) < n)

    def pad_bind(pt_idx):
        out = np.full(N_SCENE_KP, -1, np.int32)
        out[:len(pt_idx)] = np.asarray(pt_idx)
        return out

    jff = lambda f: JFeatureFrame(**{k: jnp.asarray(v) for k, v in f.items()})
    X0 = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                   rng.uniform(4, 9, n_pts)], 1).astype(np.float32)
    desc0 = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    uv0 = np.asarray(jcam.pinhole_project(jnp.asarray(K4), jnp.asarray(X0)))
    jcfg = jsystem.SlamConfig(cam_params=K4, image_hw=(480, 752), enable_loop_closing=True,
                              map_capacity=jstate.MapCapacity(**SCENE_CAP), **cfg_kw)
    tcfg = tsystem.SlamConfig(cam_params=K4, image_hw=(480, 752), enable_loop_closing=True,
                              map_capacity=MapCapacity(**SCENE_CAP), **cfg_kw)
    if inertial:
        jsys = jis.InertialSystem(jcfg, jis.InertialConfig(imu_freq=200.0))
        tsys = tis.InertialSystem(tcfg, tis.InertialConfig(imu_freq=200.0), device="cpu")
        jsys.imu_initialized = tsys.imu_initialized = True
    else:
        jsys, tsys = jsystem.System(jcfg), tsystem.System(tcfg, device="cpu")

    # the archived session: keyframe 0 at the origin observing the place
    m_old = jstate.empty_map(jcfg.map_capacity)
    m_old, k0 = jstate.add_keyframe(m_old, jnp.eye(3), jnp.zeros(3), 0.0, 0)
    m_old, pt0 = jstate.add_points(m_old, jnp.asarray(X0), jnp.asarray(desc0),
                                   jnp.tile(jnp.array([0.0, 0, 1]), (n_pts, 1)),
                                   jnp.full(n_pts, 1.0), jnp.full(n_pts, 30.0), 0, 0,
                                   jnp.ones(n_pts, bool))
    m_old = jstate.add_observations(m_old, k0, pt0, jnp.asarray(uv0),
                                    jnp.zeros(n_pts, jnp.int32), jnp.ones(n_pts, bool))
    ff0, bind0 = pad_ff(uv0, desc0), pad_bind(pt0)
    bow, _ = jsys.loop_closer._bow(jff(ff0).desc, jff(ff0).valid)
    old_db = jkdb.add(jkdb.KeyframeDB.create(SCENE_CAP["n_kf"], jsys.loop_closer.cfg.n_words),
                      0, bow)
    jsys.atlas.sessions.append(jatlas.MapSession(
        map=m_old, kf_features={0: jff(ff0)}, kf_bindings={0: jnp.asarray(bind0)},
        trajectory=[(0.0, np.eye(3), np.zeros(3))], db=old_db))

    # the current map: the same place from a rigid offset (metric when inertial)
    Rz = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.0, 0.25])))
    dtv = np.array([1.0, -0.5, 0.3], np.float32)
    X_cur = (X0 @ Rz.T + dtv).astype(np.float32)
    R_cur = jnp.asarray(Rz.T, jnp.float32)
    t_cur = jnp.asarray(-Rz.T @ dtv, jnp.float32)
    m = jsys.map
    m, kA = jstate.add_keyframe(m, R_cur, t_cur, 10.0, 100)
    m, kB = jstate.add_keyframe(m, R_cur, t_cur, 10.5, 101)
    m, ptc = jstate.add_points(m, jnp.asarray(X_cur), jnp.asarray(desc0),
                               jnp.tile(jnp.array([0.0, 0, 1]), (n_pts, 1)),
                               jnp.full(n_pts, 1.0), jnp.full(n_pts, 30.0), int(kB), 101,
                               jnp.ones(n_pts, bool))
    m = jstate.add_observations(m, kB, ptc, jnp.asarray(uv0), jnp.zeros(n_pts, jnp.int32),
                                jnp.ones(n_pts, bool))
    vels = np.zeros((SCENE_CAP["n_kf"], 3), np.float32)
    vels[0] = [0.4, 0.1, -0.2]
    vels[1] = [0.5, 0.0, -0.1]
    m = m._replace(kf_vel=jnp.asarray(vels))
    ptc = np.asarray(ptc)
    feats = {0: pad_ff(uv0[:50], desc0[:50]), 1: pad_ff(uv0, desc0)}
    binds = {0: pad_bind(ptc[:50]), 1: pad_bind(ptc)}
    jsys.map = m
    jsys.kf_features = {k: jff(f) for k, f in feats.items()}
    jsys.kf_bindings = {k: jnp.asarray(b) for k, b in binds.items()}
    jsys.R_cur, jsys.t_cur = R_cur, t_cur
    jsys.last_kf_idx, jsys.n_kf_host = 1, 2
    # the port: the JAX system's state and Atlas session, and the bank that
    # its dictionaries stand for (the JAX test builds none)
    H.copy_system_state(jsys, tsys)
    assert tsys.atlas.n_maps == 1 and tsys.bank is None
    tsys.bank = convert.bank_from_frames(SCENE_CAP["n_kf"], feats, binds)
    if inertial:
        for s_ in (jsys, tsys):
            s_.preint_kf_pairs = [(0, 1)]
        jsys.vel = jnp.asarray(vels[1])
        jsys.last_body = jsys._cam_to_body(R_cur, t_cur)
        tsys.vel = torch.from_numpy(vels[1].copy())
        tsys.last_body = tsys._cam_to_body(tsys.R_cur, tsys.t_cur)
    return jsys, tsys, feats[1], ptc


@pytest.mark.parametrize("inertial", [True, False], ids=["inertial", "monocular"])
def test_try_merge_matches_jax_on_the_two_session_scene(inertial):
    """`try_merge` on TestInertialMerge's scene, the port drawing JAX's Sim3
    samples (`PRNGKey(1000 + kf_idx)`): both merge, with offsets (1, 200);
    the welded map's integer fields as JAX's, poses within 1e-4 and points
    within 1e-4 of the scene's extent after the welding BA; the merge edge
    (2, 0) and its Sim3 within 1e-5; the database rebuilt over the merged
    keyframes (tf within 1e-6); the tracker on the welded keyframe; the
    trajectories in order; the spliced bank equal to JAX's remapped
    dictionaries.  Inertial (IMU initialized, so a rigid weld): the
    preintegration pairs shifted, the velocity carried and mirrored to the
    tracker within 1e-5, and the JAX test's gates (distances kept within
    1e-4 relative, the welded keyframe's centre within 0.2 of the origin).
    Monocular: the Sim3 with a free scale (the scene is rigid, so it finds
    1 as well)."""
    jsys, tsys, ffB, ptc = _scene(inertial)
    pre = H.fields(jsys.map)
    assert jmerge.try_merge(jsys, JFeatureFrame(**{k: jnp.asarray(v) for k, v in ffB.items()}), 1)
    assert tmerge.try_merge(
        tsys, convert.frame_from_numpy(ffB), 1,
        idx_fn=lambda kf, valid: _jax_draw(jax.random.PRNGKey(1000 + kf), valid))
    lm = tsys.last_merge
    assert (lm["session"], lm["kf"], lm["cand"], lm["kf_off"], lm["pt_off"]) == (0, 1, 0, 1, 200)
    assert lm["n_inliers"] >= 20
    assert tsys.atlas.n_maps == jsys.atlas.n_maps == 0
    assert tsys.n_kf_host == jsys.n_kf_host == 3 and tsys.last_kf_idx == jsys.last_kf_idx == 2
    g, r = convert.to_numpy(tsys.map), H.fields(jsys.map)
    extent = np.abs(r["pt_xyz"][:400]).max()
    _fields_close(g, r, atol=1e-5, skip=("kf_R", "kf_t", "pt_xyz", "kf_vel", "loop_t"))
    np.testing.assert_allclose(g["kf_R"], r["kf_R"], atol=1e-4)
    np.testing.assert_allclose(g["kf_t"], r["kf_t"], atol=1e-4)
    assert np.abs(g["pt_xyz"] - r["pt_xyz"]).max() < 1e-4 * extent
    np.testing.assert_allclose(g["kf_vel"], r["kf_vel"], atol=1e-5)
    np.testing.assert_allclose(g["loop_t"], r["loop_t"], atol=1e-5)
    assert (int(g["n_loop"]), g["loop_i"][0], g["loop_j"][0]) == (1, 2, 0)
    np.testing.assert_allclose(tsys.R_cur.numpy(), np.asarray(jsys.R_cur), atol=1e-4)
    np.testing.assert_allclose(tsys.t_cur.numpy(), np.asarray(jsys.t_cur), atol=1e-4)
    assert not tsys.has_velocity and not jsys.has_velocity
    db_t, db_j = convert.to_numpy(tsys.loop_closer.db), H.fields(jsys.loop_closer.db)
    np.testing.assert_array_equal(db_t["active"], db_j["active"])
    assert db_t["active"][:3].all()
    np.testing.assert_allclose(db_t["tf"], db_j["tf"], atol=1e-6)
    assert [e[0] for e in tsys.trajectory] == [e[0] for e in jsys.trajectory]
    bank = convert.to_numpy(tsys.bank)
    for k, f in jsys.kf_features.items():
        np.testing.assert_array_equal(bank["xy"][k], np.asarray(f.xy))
        np.testing.assert_array_equal(bank["kp_pt"][k], np.asarray(jsys.kf_bindings[k]))
    assert sorted(jsys.kf_features) == [0, 1, 2] and not bank["valid"][3:].any()
    if not inertial:
        return
    assert tsys.preint_kf_pairs == jsys.preint_kf_pairs == [(1, 2)]
    np.testing.assert_allclose(tsys.vel.numpy(), np.asarray(jsys.vel), atol=1e-5)
    np.testing.assert_allclose(tsys.vel.numpy(), g["kf_vel"][2], atol=1e-6)
    assert tsys.frame_prior is None and tsys._map_updated
    new_idx = ptc + 200
    d_before = np.linalg.norm(pre["pt_xyz"][ptc][:20] - pre["pt_xyz"][ptc][20:40], axis=1)
    d_after = np.linalg.norm(g["pt_xyz"][new_idx][:20] - g["pt_xyz"][new_idx][20:40], axis=1)
    np.testing.assert_allclose(d_after, d_before, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(g["kf_vel"][1:3], axis=1),
                               np.linalg.norm(pre["kf_vel"][:2], axis=1), rtol=1e-4)
    assert np.linalg.norm(-g["kf_R"][2].T @ g["kf_t"][2]) < 0.2


def test_inertial_merge_in_keyframe_order_keeps_the_tracker_moving(monkeypatch):
    """The real order of an inertial merge: a new keyframe of the moving
    tracker (velocity [0.5, 0, -0.1]) goes through `_insert_keyframe` -- the
    keyframe step, then `try_merge` from `_post_ba_stages` (system.py:876),
    then the keyframe's velocity and bias are stored -- on
    TestInertialMerge's scene with the IMU initialized, in both packages (the
    port draws JAX's Sim3 samples).  Both weld the new keyframe (index 3) to
    the same pose.  JAX sets the tracker's velocity to the welded keyframe's
    stored one, which is written only after the step that merged: zero, a
    restart from rest, stored as the keyframe's velocity too.  The port
    transports the tracker's own velocity by the merge's world Sim3, as the
    keyframes' stored velocities ride it (a deliberate difference, ROADMAP
    queue 3): s R v, the same speed (a rigid weld), and the keyframe stores
    it."""
    jsys, tsys, ffB, ptc = _scene(True, local_view_points=2048)
    v0 = np.asarray(jsys.vel).copy()
    np.testing.assert_array_equal(tsys.vel.numpy(), v0)
    assert np.linalg.norm(v0) > 0.5
    bind = np.full(N_SCENE_KP, -1, np.int32)
    bind[:len(ptc)] = ptc
    jtr = types.SimpleNamespace(kp_pt=jnp.asarray(bind), R=jsys.R_cur, t=jsys.t_cur)
    ttr = types.SimpleNamespace(kp_pt=torch.from_numpy(bind), R=tsys.R_cur, t=tsys.t_cur)
    jsys._insert_keyframe(JFeatureFrame(**{k: jnp.asarray(v) for k, v in ffB.items()}),
                          jtr, 11.0, 200)
    real = tmerge.try_merge
    monkeypatch.setattr(tmerge, "try_merge", lambda system, ff, kf_idx: real(
        system, ff, kf_idx,
        idx_fn=lambda kf, valid: _jax_draw(jax.random.PRNGKey(1000 + kf), valid)))
    tsys._insert_keyframe(convert.frame_from_numpy(ffB), ttr, 11.0, 200)
    assert jsys.atlas.n_maps == tsys.atlas.n_maps == 0
    assert jsys.last_kf_idx == tsys.last_kf_idx == 3
    assert (tsys.last_merge["kf"], tsys.last_merge["cand"], tsys.last_merge["kf_off"]) == (2, 0, 1)
    np.testing.assert_allclose(tsys.R_cur.numpy(), np.asarray(jsys.R_cur), atol=1e-4)
    np.testing.assert_allclose(tsys.t_cur.numpy(), np.asarray(jsys.t_cur), atol=1e-4)
    # JAX: the tracker restarts from rest, and the keyframe stores it
    np.testing.assert_array_equal(np.asarray(jsys.vel), np.zeros(3, np.float32))
    np.testing.assert_array_equal(np.asarray(jsys.map.kf_vel[3]), np.zeros(3, np.float32))
    # the port: the tracker's own velocity in the merged world
    lm = tsys.last_merge
    assert abs(lm["s"] - 1.0) < 1e-5
    want = lm["s"] * lm["R"] @ v0
    np.testing.assert_allclose(tsys.vel.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(tsys.vel.numpy()), np.linalg.norm(v0), rtol=1e-5)
    np.testing.assert_allclose(tsys.map.kf_vel[3].numpy(), tsys.vel.numpy(), atol=0)


# --- the port's own drive (test_sessions_weld_on_revisit) --------------------------

def test_sessions_weld_on_revisit():
    """test_sessions_weld_on_revisit's 80 frames on the port at a 32-keyframe
    capacity: frames 30-33 lose every keypoint and, with relocalization
    switched off on the instance as the JAX test does, the map is reset into
    the Atlas; the second map welds into the first on the revisit.  The JAX
    test's gates: at least one reset, the session consumed, OK at the end,
    at least 8 valid keyframes from both sessions, a merged trajectory over
    more than 70% of the frames with an ATE below 0.08; and the merge edge
    (welded keyframe, candidate) persisted in the map."""
    world = SyntheticWorld(seed=13)
    n = 80
    poses = camera_path(n, speed=0.05)
    cfg = tsystem.SlamConfig(
        cam_params=K4, image_hw=HW, min_init_matches=80, max_frames_between_kf=6,
        ba_caps=(24, 4096, 16384), enable_loop_closing=True, reloc_patience=2,
        map_capacity=MapCapacity(n_kf=32, n_pt=4096, n_obs=32768), local_view_points=2048)
    sys_ = tsystem.System(cfg, device="cpu")
    sys_._handle_tracking_loss = lambda ff: False
    for i, (R, t, _) in enumerate(poses):
        f = {k: np.array(v) for k, v in H.fields(world.frame(R, t)).items()}
        if 30 <= i < 34:
            f["valid"][:] = False
        sys_.track_monocular(None, ts=i * 0.05, features=convert.frame_from_numpy(f))
    assert sys_.n_resets >= 1
    assert sys_.atlas.n_maps == 0, sys_.atlas.n_maps
    assert sys_.state == tsystem.OK
    assert int(sys_.map.kf_valid.sum()) >= 8
    lm = sys_.last_merge
    weld = lm["kf"] + lm["kf_off"]
    edges = list(zip(sys_.map.loop_i.tolist(), sys_.map.loop_j.tolist()))[:int(sys_.map.n_loop)]
    assert (weld, lm["cand"]) in edges
    est = np.stack([p[2] for p in sys_.trajectory])
    gt = np.stack([poses[int(round(p[0] / 0.05))][2] for p in sys_.trajectory])
    assert len(est) > n * 0.7
    rmse, *_ = talign.ate_rmse(est, gt)
    assert rmse < 0.08, rmse
