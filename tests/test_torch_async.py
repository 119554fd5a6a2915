"""The port's pending chain against the JAX package's: the swap-in of an
optimized snapshot (`_merge_opt`, with keyframes and points appended after
the snapshot rebased by the anchor correction A), the "gba" merge's tracker
and inertial rebase, and the async keyframe tail `_cull_ba`; then the port's
own drives with `tests/test_async_mapping.py`'s gates, and the forced
merges that must also absorb the GBA a keyframe chain's loop closure posts.

On the CPU the chain runs inline and a poll always finds it done, while the
JAX CPU backend may merge a frame later, so the drives are held to their
gates and the merges to JAX's values on the same inputs.  Each test states
its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.pipeline import inertial_system as jis
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu.solver import vi_pose_opt as jvpo
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import loop_closing as tloop
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map import feature_bank as fb
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.utils import align as talign
from orbslam3_tpu_torch.utils import loop_scene as ls
from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path
from test_torch_gba import CAP, N_KF, N_PT, _jax_map

torch.set_num_threads(2)

COMMON = dict(cam_params=K4, image_hw=HW, enable_relocalization=False, local_view_points=2048,
              ba_caps=(8, 512, 2048))


@pytest.fixture(scope="module")
def maps():
    """(snapshot, optimized snapshot, live map, bank): the optimized
    snapshot moves every keyframe and point and culls 10 points; the live
    map appends 2 keyframes and 40 points after the snapshot and counts
    tracking on every point."""
    m, bank = _jax_map(seed=1)
    rng = np.random.default_rng(2)
    f = H.fields(m)
    opt = {k: v.copy() for k, v in f.items()}
    opt["kf_t"][:N_KF] += rng.normal(0, 0.05, (N_KF, 3)).astype(np.float32)
    opt["kf_vel"][:N_KF] = rng.normal(0, 1, (N_KF, 3)).astype(np.float32)
    opt["kf_bias"][:N_KF] = rng.normal(0, 0.01, (N_KF, 6)).astype(np.float32)
    opt["pt_xyz"][:N_PT] += rng.normal(0, 0.05, (N_PT, 3)).astype(np.float32)
    opt["pt_valid"][rng.choice(N_PT, 10, replace=False)] = False
    live = m
    for k in range(N_KF, N_KF + 2):
        R = jnp.asarray(np.eye(3, dtype=np.float32))
        live, _ = jstate.add_keyframe(live, R, jnp.asarray([-0.25 * k, 0.1, 0.0]), 0.1 * k, k,
                                      vel=jnp.asarray([0.3, 0.0, 0.1 * k]))
    X = rng.normal(0, 1, (40, 3)).astype(np.float32) + np.array([0, 0, 6], np.float32)
    live, _ = jstate.add_points(live, jnp.asarray(X), jnp.zeros((40, 8), jnp.uint32),
                                jnp.tile(jnp.asarray([0.0, 0, 1]), (40, 1)), jnp.ones(40),
                                jnp.full(40, 30.0), N_KF, N_KF, jnp.ones(40, bool))
    live = live._replace(pt_found=live.pt_found + 3, pt_visible=live.pt_visible + 5)
    return m, jstate.MapState(**{k: jnp.asarray(v) for k, v in opt.items()}), live, bank


def test_merge_opt_matches_jax(maps):
    """`_merge_opt`: the snapshot's geometry and cull verdicts, the live
    counters, the appended keyframes and points rebased by A (poses,
    velocities and points within 1e-5); the live map's other fields as they
    were."""
    _, m_opt, m_live, _ = maps
    ref = jsystem.System(jsystem.SlamConfig(cam_params=K4, map_capacity=jstate.MapCapacity(
        **CAP), enable_relocalization=False))._merge_opt(m_live, m_opt)
    tl, to = (convert.map_from_numpy(H.fields(x)) for x in (m_live, m_opt))
    got = convert.to_numpy(tsystem.merge_opt(tl, to))
    r = H.fields(ref)
    for name in r:
        if name in ("kf_R", "kf_t", "kf_vel", "pt_xyz"):
            np.testing.assert_allclose(got[name], r[name], atol=1e-5, err_msg=name)
        else:
            ref_v = r[name].view(np.int32) if r[name].dtype == np.uint32 else r[name]
            np.testing.assert_array_equal(got[name], ref_v, err_msg=name)
    # the appended keyframes moved (A is not the identity) and kept their bias
    assert np.abs(got["kf_t"][N_KF] - H.fields(m_live)["kf_t"][N_KF]).max() > 1e-3
    assert int(got["pt_found"][0]) == int(H.fields(m_live)["pt_found"][0])


def _jsys(inertial):
    cfg = jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **COMMON)
    return jis.InertialSystem(cfg, jis.InertialConfig()) if inertial else jsystem.System(cfg)


def _tsys(inertial):
    cfg = tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **COMMON)
    return tis.InertialSystem(cfg, tis.InertialConfig(), device="cpu") if inertial else \
        tsystem.System(cfg, device="cpu")


@pytest.mark.parametrize("inertial", [False, True])
def test_gba_merge_rebases_the_tracker_as_jax(maps, inertial):
    """A "gba" pending entry merged with force: the merged map, the tracker's
    current and previous poses carried by A (within 1e-5), the motion model
    dropped, the view rebuilt (the same point slots); on the inertial tracker
    also the velocity rotated by R_A (1e-5), the frame prior dropped, the
    body pose recomputed and the map marked updated."""
    _, m_opt, m_live, bank = maps
    rng = np.random.default_rng(4)
    pose = [np.asarray(x, np.float32) for x in (
        np.eye(3), [-2.0, 0.1, 0.2], np.eye(3), [-1.9, 0.1, 0.2], [0.4, 0.1, -0.2])]
    js, ts = _jsys(inertial), _tsys(inertial)
    js.map, js.bank = m_live, bank
    ts.map, ts.bank = (convert.map_from_numpy(H.fields(m_live)),
                       convert.bank_from_numpy(H.fields(bank)))
    for s, conv in ((js, jnp.asarray), (ts, lambda a: torch.from_numpy(a.copy()))):
        s.R_cur, s.t_cur, s.R_prev, s.t_prev = (conv(a) for a in pose[:4])
        s.has_velocity, s.last_kf_idx, s.n_kf_host = True, N_KF + 1, N_KF + 2
        if inertial:
            s.vel = conv(pose[4])
            s._map_updated = False
    ts._pose_host = None
    if inertial:
        H_prior = rng.normal(size=(15, 15)).astype(np.float32)
        js.frame_prior = jvpo.VIPosePrior(Rwb=js.R_cur, pwb=js.t_cur, vel=js.vel,
                                          bias=jnp.zeros(6), H=jnp.asarray(H_prior))
        ts.frame_prior = "a prior to drop"
    js._pending = (m_opt, N_KF - 1, "gba")
    ts._pending = tsystem.Pending(convert.map_from_numpy(H.fields(m_opt)), N_KF - 1, "gba",
                                  None, 0.0, None, ())
    js._merge_pending(force=True)
    ts._merge_pending(force=True)
    assert ts._pending is None and js._pending is None
    assert ts.chain_counts["merged gba forced"] == 1
    np.testing.assert_allclose(ts.map.pt_xyz.numpy(), np.asarray(js.map.pt_xyz), atol=1e-5)
    for name in ("R_cur", "t_cur", "R_prev", "t_prev") + (("vel",) if inertial else ()):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=1e-5, err_msg=name)
    assert not ts.has_velocity and not js.has_velocity
    np.testing.assert_array_equal(ts.view.idx.numpy(), np.asarray(js.view.idx))
    if inertial:
        assert ts.frame_prior is None and ts._map_updated and js._map_updated
        for a, b in zip(ts.last_body, js.last_body):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_cull_ba_matches_jax(maps):
    """`_cull_ba` (point culling, then the window BA from the bank) on the
    JAX-built map at frame 40 with some points failing the found ratio: the
    same cull verdicts, keyframe poses within 1e-4 and points within 1e-3
    of the map's extent."""
    m, _, _, bank = maps
    rng = np.random.default_rng(6)
    f = {k: np.array(v) for k, v in H.fields(m).items()}
    f["pt_found"][:N_PT] = rng.integers(0, 4, N_PT)
    f["pt_visible"][:N_PT] = 6
    m = jstate.MapState(**{k: jnp.asarray(v) for k, v in f.items()})
    jcfg = jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **COMMON)
    tcfg = tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **COMMON)
    ref = H.fields(jsystem.System(jcfg)._cull_ba(m, jnp.asarray(40, jnp.int32),
                                                 jnp.asarray(N_KF - 1, jnp.int32), bank))
    got = convert.to_numpy(tsystem.cull_ba(tcfg, torch.tensor(K4), convert.map_from_numpy(f),
                                           40, N_KF - 1, convert.bank_from_numpy(H.fields(bank))))
    np.testing.assert_array_equal(got["pt_valid"], ref["pt_valid"])
    assert 0 < int(ref["pt_valid"].sum()) < N_PT
    np.testing.assert_allclose(got["kf_R"], ref["kf_R"], atol=1e-4)
    np.testing.assert_allclose(got["kf_t"], ref["kf_t"], atol=1e-4)
    scale = np.abs(ref["pt_xyz"][:N_PT]).max()
    assert np.abs(got["pt_xyz"] - ref["pt_xyz"]).max() < 1e-3 * scale


# --- the port's own drives (test_async_mapping.py's gates) -------------------------

DRIVE = dict(cam_params=K4, image_hw=HW, min_init_matches=80, max_frames_between_kf=6,
             map_capacity=MapCapacity(n_kf=32, n_pt=4096, n_obs=32768), local_view_points=2048)


def _drive(n_frames, seed, blank=(), **kw):
    """test_async_mapping's drive on the port: SyntheticWorld features on
    camera_path, 20 frames per second; frames in `blank` lose every
    keypoint.  Returns (System, ATE RMSE)."""
    world = SyntheticWorld(seed=seed)
    poses = camera_path(n_frames)
    sys_ = tsystem.System(tsystem.SlamConfig(**DRIVE, **kw), device="cpu")
    for i, (R, t, _) in enumerate(poses):
        f = {k: np.array(v) for k, v in H.fields(world.frame(R, t)).items()}
        if i in blank:
            f["valid"][:] = False
        sys_.track_monocular(None, ts=i * 0.05, features=convert.frame_from_numpy(f))
    assert sys_.state == tsystem.OK and sys_.n_resets == 0
    est = np.stack([p[2] for p in sys_.trajectory])
    gt = np.stack([poses[int(round(p[0] / 0.05))][2] for p in sys_.trajectory])
    rmse, *_ = talign.ate_rmse(est, gt)
    return sys_, rmse


def test_async_tracks_like_sync():
    """48 frames with async mapping (and loop closing, which detects at every
    keyframe and must close nothing here) and without: both accurate (ATE
    below 0.06 and 0.05, the JAX test's gates), every posted keyframe chain
    merged, nothing pending after shutdown, at least 6 keyframes."""
    sys_a, rmse_a = _drive(48, 7, async_mapping=True, enable_loop_closing=True)
    _, rmse_s = _drive(48, 7, enable_relocalization=False)
    assert rmse_s < 0.05 and rmse_a < 0.06, (rmse_s, rmse_a)
    c = sys_a.chain_counts
    assert c["posted kf"] >= 6 and \
        c["merged kf at a poll"] + c["merged kf forced"] + (sys_a._pending is not None) == \
        c["posted kf"]
    sys_a.shutdown()
    assert sys_a._pending is None and sys_a.n_kf_host >= 6
    assert sys_a.loop_closer.n_loops_closed == 0


def test_async_survives_reset_and_loss():
    """A two-frame blackout right after a keyframe, with its chain posted:
    the loss path merges before relocalizing, the run ends OK without a
    reset, and a poll leaves nothing pending."""
    sys_, _ = _drive(40, 3, blank=(24, 25), async_mapping=True)
    assert sys_.chain_counts["posted kf"] >= 3
    sys_._merge_pending(force=False)
    assert sys_._pending is None


@pytest.mark.parametrize("end", ["shutdown", "reset"])
def test_forced_merge_absorbs_the_gba_a_keyframe_chain_posts(end):
    """The last keyframe chain closes a loop at its swap-in (the drifted
    revisit of `utils/loop_scene`, posted as a "kf" pending entry): the
    closure posts the post-loop GBA, and shutdown() or reset() merges that
    too, so nothing is left pending and the GBA lands in the map it was run
    on (the active one, or the archived session), never in a fresh map.
    The revisit keyframe's centre ends within 0.15 of the origin."""
    cfg = tsystem.SlamConfig(map_capacity=MapCapacity(n_kf=32, n_pt=4096, n_obs=16384),
                             cam_params=ls.K4, image_hw=(480, 752), local_view_points=2048,
                             enable_relocalization=False, async_mapping=True,
                             enable_loop_closing=True)
    sys_ = tsystem.System(cfg, device="cpu")
    rev = ls.build(sys_)
    sys_.loop_closer = tloop.LoopCloser(tloop.LoopConfig(n_words=4096, consistency_needed=0,
                                                         min_kf_gap=5), 32, "cpu")
    for k in range(rev.kr):
        sys_.loop_closer.add_keyframe(sys_.map, k, fb.frame_view(sys_.bank, k))
    sys_.state = tsystem.OK
    sys_._pending = tsystem.Pending(sys_.map, rev.kr, "kf", rev.ff, float(rev.kr), None, ())
    getattr(sys_, end)()
    assert sys_._pending is None and sys_.loop_closer.n_loops_closed == 1
    c = sys_.chain_counts
    assert c["merged kf forced"] == 1 and c["posted gba"] == 1 and c["merged gba forced"] == 1
    m = sys_.map if end == "shutdown" else sys_.atlas.sessions[-1].map
    assert float(torch.linalg.norm(-m.kf_R[rev.kr].T @ m.kf_t[rev.kr])) < 0.15
    if end == "reset":
        assert not bool(sys_.map.kf_valid.any()) and sys_.state == tsystem.NO_IMAGES_YET
