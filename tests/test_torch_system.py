"""The port's `System` against the JAX package's, and its state machine.

Fed features, as `tests/test_pipeline_e2e.py` feeds them (`SyntheticWorld`:
512 keypoints a frame with stable descriptors), at a small map capacity.
One JAX `System` boots itself once; what its initialization was given is
recorded, so that the port's `search_for_initialization` and
`_create_initial_map` run on the same features, matches and two-view result,
and the port's `System` then continues from a copy of the JAX one's state on
the same frames.  The state machine's own cases (timestamp failsafes, the
loss path, localization mode, the refused flags) run on the port alone,
which boots with its own RANSAC draw.
"""

import copy
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.ops import lie as tlie
from orbslam3_tpu_torch.ops import matching as tmatching
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.utils import align as talign
from orbslam3_tpu_torch.utils import seeded_scene as ss
from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path

torch.set_num_threads(2)

CAP = dict(n_kf=32, n_pt=4096, n_obs=32768)
COMMON = dict(cam_params=K4, image_hw=HW, min_init_matches=80, local_view_points=2048,
              ba_caps=(16, 2048, 8192), new_pt_budget=256)
DT = 0.05


def _tcfg(**kw):
    return tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **{**COMMON, **kw})


def _jcfg(**kw):
    return jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **{**COMMON, **kw})


@functools.lru_cache(maxsize=None)
def _frames(seed=2, n=40):
    """The world's frames as dicts of numpy arrays, made once: the world
    draws its noise from one generator, frame after frame."""
    world = SyntheticWorld(seed=seed)
    return [H.fields(world.frame(R, t)) for R, t, _ in camera_path(n)]


def _jff(f):
    return jsystem.FeatureFrame(**{k: jnp.asarray(v) for k, v in f.items()})


def _tff(f):
    return convert.frame_from_numpy(f)


@pytest.fixture(scope="module")
def jax_boot():
    """A JAX System fed frames until it has initialised, with the inputs and
    the result of its `_create_initial_map` recorded, then 3 frames more."""
    jsys = jsystem.System(_jcfg(max_frames_between_kf=6))
    rec = {}
    create = jsys._create_initial_map

    def spy(ff, mm, res, ts):
        rec.update(ref_ff=H.fields(jsys.ref_ff), ref_ts=jsys.ref_ts,
                   ref_frame_id=jsys.ref_frame_id, frame_id=jsys.frame_id,
                   ff=H.fields(ff), mm=H.fields(mm), res=H.fields(res), ts=ts)
        create(ff, mm, res, ts)
        rec.update(map=H.fields(jsys.map), bank=H.fields(jsys.bank),
                   inliers_at_last_kf=jsys.inliers_at_last_kf)

    jsys._create_initial_map = spy
    frames = _frames()
    i = 0
    while jsys.state != jsystem.OK:
        assert i < 12, "the JAX system did not initialise"
        jsys.track_monocular(None, ts=i * DT, features=_jff(frames[i]))
        i += 1
    for _ in range(3):
        jsys.track_monocular(None, ts=i * DT, features=_jff(frames[i]))
        i += 1
    assert jsys.state == jsystem.OK
    return jsys, rec, i


def test_search_for_initialization_matches_jax(jax_boot):
    _, rec, _ = jax_boot
    mm = tmatching.search_for_initialization(_tff(rec["ref_ff"]), _tff(rec["ff"]),
                                             radius=100.0, nn_ratio=0.9)
    np.testing.assert_array_equal(mm.valid.numpy(), rec["mm"]["valid"])
    np.testing.assert_array_equal(mm.idx.numpy(), rec["mm"]["idx"])
    np.testing.assert_array_equal(mm.dist.numpy(), rec["mm"]["dist"])
    assert int(mm.valid.sum()) >= 80


def test_search_by_brute_force_matches_jax(jax_boot):
    from orbslam3_tpu.ops import matching as jmatching
    _, rec, _ = jax_boot
    ref = jmatching.search_by_brute_force(_jff(rec["ref_ff"]), _jff(rec["ff"]))
    got = tmatching.search_by_brute_force(_tff(rec["ref_ff"]), _tff(rec["ff"]))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def test_create_initial_map_matches_jax(jax_boot):
    """From the JAX system's own features, matches and two-view result: the
    same slots and bindings, keyframe poses within 1e-4, and the points after
    the two-keyframe BA and the renormalisation within 1e-3 relative across
    the viewing ray.  Along the ray a point seen under a parallax angle a is
    determined only to the cross-ray noise over sin(a): the two keyframes of
    this scene are two frames apart and see the points under 0.5-0.9
    degrees (measured: 4e-5 across the ray, up to 4.4e-3 along it at 0.6
    degrees, with poses 2e-5 apart), so along the ray the bound is
    1e-4 / sin(a) relative, and 6e-3 relative whatever the angle."""
    _, rec, _ = jax_boot
    tsys = tsystem.System(_tcfg(max_frames_between_kf=6), device="cpu")
    tsys.ref_ff = _tff(rec["ref_ff"])
    tsys.ref_ts, tsys.ref_frame_id = rec["ref_ts"], rec["ref_frame_id"]
    tsys.frame_id = rec["frame_id"]
    tsys.state = tsystem.NOT_INITIALIZED
    tsys._create_initial_map(_tff(rec["ff"]), convert.matches_from_numpy(rec["mm"]),
                             convert.twoview_from_numpy(rec["res"]), rec["ts"])
    assert tsys.state == tsystem.OK and tsys.n_kf_host == 2 and tsys.last_kf_idx == 1
    assert tsys.inliers_at_last_kf == rec["inliers_at_last_kf"]
    assert tsys.init_info["n_points"] == int(rec["res"]["triangulated"].sum())
    mj, mt = rec["map"], convert.to_numpy(tsys.map)
    for name in ("pt_valid", "pt_ref_kf", "pt_first_frame", "pt_desc", "obs_kf", "obs_pt",
                 "obs_valid", "obs_octave", "n_kf", "n_pt", "n_obs", "kf_valid",
                 "kf_frame_id", "pt_kf_mask"):
        got = mt[name]
        ref = mj[name].view(np.int32) if mj[name].dtype == np.uint32 else mj[name]
        np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_array_equal(convert.to_numpy(tsys.bank.kp_pt), rec["bank"]["kp_pt"])
    np.testing.assert_allclose(mt["kf_R"][:2], mj["kf_R"][:2], atol=1e-4)
    np.testing.assert_allclose(mt["kf_t"][:2], mj["kf_t"][:2], atol=1e-4)
    v = mj["pt_valid"]
    assert v.sum() >= 50
    X = mj["pt_xyz"][v]
    depth = np.linalg.norm(X, axis=1)
    ray = X / depth[:, None]
    O2 = -mj["kf_R"][1].T @ mj["kf_t"][1]
    ray2 = (X - O2) / np.linalg.norm(X - O2, axis=1, keepdims=True)
    sin_par = np.linalg.norm(np.cross(ray, ray2), axis=1)
    d = mt["pt_xyz"][v] - X
    along = np.abs(np.sum(d * ray, axis=1))
    across = np.linalg.norm(d - np.sum(d * ray, axis=1, keepdims=True) * ray, axis=1)
    assert (across / depth).max() < 1e-3
    assert (along / depth * sin_par).max() < 1e-4
    assert (along / depth).max() < 6e-3          # the measured ceiling, 4.4e-3, with margin
    np.testing.assert_allclose(mt["pt_min_dist"][v], mj["pt_min_dist"][v], rtol=1e-5)
    # renormalised: the median depth in the second keyframe is 1
    Xc = mt["pt_xyz"][v] @ mt["kf_R"][1].T + mt["kf_t"][1]
    assert np.median(Xc[:, 2]) == pytest.approx(1.0, abs=1e-4)
    assert tsys.view is not None and int(tsys.view.valid.sum()) == v.sum()
    assert len(tsys.trajectory) == 1


@pytest.mark.parametrize("n", [6, 7, 1, 0])
def test_masked_median_averages_the_two_middle_values(n):
    """T4: an even count averages the two middle values, as np.nanmedian and
    jnp.nanmedian do; torch.nanmedian would return the lower one."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=16).astype(np.float32)
    mask = np.zeros(16, bool)
    mask[rng.permutation(16)[:n]] = True
    got = float(tsystem.masked_median(torch.from_numpy(x), torch.from_numpy(mask)))
    if n == 0:
        assert np.isnan(got)
        return
    assert got == pytest.approx(float(np.nanmedian(np.where(mask, x, np.nan))), abs=1e-7)
    assert got == pytest.approx(float(jnp.nanmedian(jnp.where(mask, x, jnp.nan))), abs=1e-7)
    if n == 6:
        lower = float(torch.nanmedian(torch.from_numpy(np.where(mask, x, np.nan))))
        assert got != lower


def test_renorm_init_matches_jax_on_an_even_count(jax_boot):
    jsys, rec, _ = jax_boot
    m = dict(rec["map"])
    pv = m["pt_valid"].copy()
    if pv.sum() % 2:                         # make the count even
        pv[np.nonzero(pv)[0][0]] = False
    m["pt_valid"] = pv
    m["pt_xyz"] = m["pt_xyz"] * np.float32(1.7)
    m["kf_t"] = m["kf_t"] * np.float32(1.7)
    ref = jsys._renorm_init(jstate.MapState(**{k: jnp.asarray(v) for k, v in m.items()}),
                            jnp.asarray(1, jnp.int32))
    got = tsystem.renorm_init(convert.map_from_numpy(m), 1)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(ref.pt_xyz), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.kf_t.numpy(), np.asarray(ref.kf_t), rtol=1e-6, atol=1e-7)


def test_short_drive_from_a_copied_state_matches_jax(jax_boot):
    """Both Systems continue from the JAX one's state over 13 frames of the
    same features: the same state on every frame, keyframes inserted on the
    same frames, camera poses within 1e-3."""
    jsys, _, start = jax_boot
    tsys = tsystem.System(_tcfg(max_frames_between_kf=6), device="cpu")
    H.copy_system_state(jsys, tsys)
    frames = _frames()
    kf_frames_j, kf_frames_t = [], []
    for i in range(start, start + 13):
        nj, nt = jsys.n_kf_host, tsys.n_kf_host
        sj, pj = jsys.track_monocular(None, ts=i * DT, features=_jff(frames[i]))
        st, pt = tsys.track_monocular(None, ts=i * DT, features=_tff(frames[i]))
        assert st == sj == tsystem.OK, i
        if jsys.n_kf_host > nj:
            kf_frames_j.append(i)
        if tsys.n_kf_host > nt:
            kf_frames_t.append(i)
        np.testing.assert_allclose(pt[0], pj[0], atol=1e-3, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt[1], pj[1], atol=1e-3, err_msg=f"frame {i}")
        assert abs(tsys.last_track_inliers - jsys.last_track_inliers) <= \
            0.02 * jsys.last_track_inliers + 2
    assert kf_frames_t == kf_frames_j and len(kf_frames_t) >= 2
    assert tsys.n_kf_host == jsys.n_kf_host
    assert len(tsys.trajectory) == len(jsys.trajectory)
    assert int(tsys.map.pt_valid.sum()) == pytest.approx(int(jsys.map.pt_valid.sum()), rel=0.02)


# --- the port's own state machine ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _booted_once(n_warm, kf_every):
    sys_ = tsystem.System(_tcfg(max_frames_between_kf=kf_every, reloc_patience=3),
                          device="cpu")
    frames = _frames()
    for i in range(n_warm):
        sys_.track_monocular(None, ts=i * DT, features=_tff(frames[i]))
    assert sys_.state == tsystem.OK
    return sys_


def _booted(n_warm=12, kf_every=15):
    """A port System that has booted itself from `n_warm` frames, as
    `TestTimestampAnomalies._booted_system` boots the JAX one.  Booted once
    per configuration; each test gets its own copy (state tensors are never
    written in place)."""
    sys_ = copy.copy(_booted_once(n_warm, kf_every))
    sys_.trajectory = list(sys_.trajectory)
    sys_.atlas = copy.deepcopy(sys_.atlas)
    return sys_


def _feed(sys_, i, ts):
    return sys_.track_monocular(None, ts=ts, features=_tff(_frames()[i]))


def test_port_boots_itself_and_tracks():
    sys_ = _booted()
    assert sys_.init_info["frame"] <= 11 and sys_.init_info["n_points"] >= 50
    assert sys_.n_resets == 0 and sys_.n_kf_host >= 2
    assert len(sys_.trajectory) == 12 - sys_.init_info["frame"] + 1
    assert sys_.last_track_inliers >= sys_.cfg.min_track_inliers
    est = np.stack([p[2] for p in sys_.trajectory])
    gt = np.stack([camera_path(40)[int(round(p[0] / DT))][2] for p in sys_.trajectory])
    rmse, *_ = talign.ate_rmse(est, gt)
    assert rmse < 0.05


def test_backwards_timestamp_creates_map_in_atlas():
    sys_ = _booted()
    traj_len = len(sys_.trajectory)
    st, pose = _feed(sys_, 12, ts=0.2)           # older than its predecessor
    assert pose is None                          # anomalous frame dropped
    assert sys_.n_map_switches == 1 and sys_.n_resets == 0
    assert sys_.atlas.n_maps == 1
    assert sys_.state == st == tsystem.NO_IMAGES_YET
    assert len(sys_.atlas.sessions[-1].trajectory) == traj_len
    assert int(sys_.atlas.sessions[-1].map.n_kf) >= 2
    assert int(sys_.map.n_kf) == 0 and sys_.trajectory == []
    # recovery: normal frames initialise a fresh map
    for k in range(12):
        _feed(sys_, 13 + k, ts=0.65 + k * DT)
    assert sys_.state == tsystem.OK and sys_.n_resets == 0


def test_long_gap_young_map_resets():
    sys_ = _booted()
    assert sys_.n_kf_host <= 10
    st, pose = _feed(sys_, 13, ts=12 * DT + 5.0)
    assert pose is None
    assert sys_.n_resets == 1 and sys_.state == tsystem.NO_IMAGES_YET


def test_long_gap_mature_map_archives():
    sys_ = _booted(n_warm=16, kf_every=1)        # every frame a keyframe
    assert sys_.n_kf_host > 10
    st, pose = _feed(sys_, 17, ts=16 * DT + 5.0)
    assert pose is None
    assert sys_.n_resets == 0 and sys_.n_map_switches == 1     # archived, not reset
    assert sys_.atlas.n_maps == 1


def test_small_gap_is_not_an_anomaly():
    sys_ = _booted()
    _feed(sys_, 13, ts=12 * DT + 2.0)            # 2 s < image_timeout
    assert sys_.n_map_switches == 0 and sys_.n_resets == 0


def _blank():
    f = _frames()[0]
    return {k: np.zeros_like(v) for k, v in f.items()}


def test_loss_waits_for_patience_then_resets_into_the_atlas():
    """Frames without keypoints: RECENTLY_LOST for `reloc_patience` (3)
    frames with the view widened to the whole map, then the map is archived
    and a fresh one started."""
    sys_ = _booted()
    blank = _tff(_blank())
    for k in range(3):
        st, pose = sys_.track_monocular(None, ts=(12 + k) * DT, features=blank)
        assert st == tsystem.RECENTLY_LOST and pose is None
        assert sys_.lost_frames == k + 1 and sys_.view is None and not sys_.has_velocity
        assert sys_.n_resets == 0
    st, _ = sys_.track_monocular(None, ts=15 * DT, features=blank)
    assert st == tsystem.NO_IMAGES_YET
    assert sys_.n_resets == 1 and sys_.atlas.n_maps == 1
    assert int(sys_.map.n_kf) == 0 and sys_.n_kf_host == 0
    assert not bool(sys_.bank.valid.any())


def test_short_occlusion_recovers_without_reset():
    sys_ = _booted()
    blank = _tff(_blank())
    for k in range(2):
        st, _ = sys_.track_monocular(None, ts=(12 + k) * DT, features=blank)
        assert st == tsystem.RECENTLY_LOST
    st, pose = _feed(sys_, 14, ts=14 * DT)       # wide radius, the whole map
    assert st == tsystem.OK and pose is not None
    assert sys_.n_resets == 0 and sys_.lost_frames == 0


def test_localization_mode_and_exports():
    sys_ = _booted()
    nk = sys_.n_kf_host
    sys_.activate_localization_mode()
    for i in range(12, 28):
        st, _ = _feed(sys_, i, ts=i * DT)
    assert st == tsystem.OK and sys_.tracking_state == tsystem.OK
    assert sys_.n_kf_host == nk, "keyframe inserted in localization mode"
    sys_.deactivate_localization_mode()
    for i in range(28, 34):
        _feed(sys_, i, ts=i * DT)
    assert sys_.n_kf_host > nk, "mapping did not resume"
    rows = [r for r in sys_.keyframe_trajectory_tum().splitlines() if r]
    assert len(rows) == int(sys_.map.kf_valid.sum())
    assert len(rows[0].split()) == 8
    assert len(sys_.trajectory_tum().splitlines()) == len(sys_.trajectory)
    sys_.shutdown()
    sys_.reset()
    assert sys_.state == tsystem.NO_IMAGES_YET and sys_.n_resets == 1


@pytest.mark.parametrize("flag", [
    dict(enable_gnss=True), dict(ba_mesh_shards=2), dict(cam_model="kb8"),
    dict(stereo_bf=40.0)])
def test_flags_of_parts_not_ported_are_refused(flag):
    with pytest.raises(NotImplementedError, match="queue 1 item"):
        tsystem.System(tsystem.SlamConfig(**flag), device="cpu")


def test_async_mapping_and_loop_closing_build_a_system():
    """Both flags build a System: the LoopCloser with the 65536-word
    database, no pending chain, and on the CPU no side stream (the chain runs
    inline there)."""
    small = dataclasses.replace(tsystem.SlamConfig(), map_capacity=MapCapacity(**CAP),
                                async_mapping=True, enable_loop_closing=True,
                                enable_relocalization=False)
    sys_ = tsystem.System(small, device="cpu")
    assert sys_.loop_closer is not None and sys_.loop_closer.cfg.n_words == 65536
    assert sys_._pending is None and sys_._side_stream is None and sys_._async_ok
    assert sys_.map.kf_R.device.type == "cpu"


def test_loop_closing_with_a_stored_atlas_session_refuses_map_merging():
    """With an Atlas session stored, the JAX package tries map merging at the
    first keyframe (queue 1 item 5, not ported): the port raises there."""
    sys_ = _booted(n_warm=16, kf_every=1)           # every frame a keyframe
    sys_.cfg = dataclasses.replace(sys_.cfg, enable_loop_closing=True)
    sys_.atlas.store_session(sys_.map, sys_.bank, [])
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        _feed(sys_, 16, ts=16 * DT)


def test_default_config_builds_the_keyframe_database():
    """`enable_relocalization` is true by default, as in the JAX package, and
    builds the `LoopCloser` with the 65536-word vocabulary and an empty
    keyframe database of the map's keyframe capacity; switched off, there is
    none."""
    small = dataclasses.replace(tsystem.SlamConfig(), map_capacity=MapCapacity(**CAP))
    assert small.enable_relocalization
    sys_ = tsystem.System(small, device="cpu")
    assert sys_.state == tsystem.NO_IMAGES_YET and sys_.map.kf_R.device.type == "cpu"
    lc = sys_.loop_closer
    assert lc is not None and lc.cfg.n_words == 65536
    assert lc.codebook.shape == (65536, 8) and lc.codebook.dtype == torch.int32
    assert lc.db.tf.shape == (CAP["n_kf"], 65536) and not bool(lc.db.active.any())
    off = tsystem.System(dataclasses.replace(small, enable_relocalization=False), device="cpu")
    assert off.loop_closer is None


def test_rot_to_quat_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)).astype(np.float32) * np.float32(1.5)
    w[:4] = [[np.pi - 1e-3, 0, 0], [0, np.pi - 1e-3, 0], [0, 0, np.pi - 1e-3], [0, 0, 0]]
    R = np.asarray(jlie.exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(tlie.rot_to_quat(torch.from_numpy(R.copy())).numpy(),
                               np.asarray(jlie.rot_to_quat(jnp.asarray(R))), atol=1e-6)


def test_umeyama_matches_jax():
    from orbslam3_tpu.ops import align as jalign
    rng = np.random.default_rng(1)
    src = rng.normal(size=(40, 3)).astype(np.float32)
    R = np.asarray(jlie.exp_so3(jnp.asarray([0.3, -0.2, 0.5])), np.float32)
    dst = (2.5 * src @ R.T + np.array([1.0, -2.0, 0.5], np.float32)
           + 0.01 * rng.normal(size=(40, 3))).astype(np.float32)
    rj, sj, Rj, tj = jalign.ate_rmse(jnp.asarray(src), jnp.asarray(dst))
    rt, st, Rt, tt = talign.ate_rmse(src, dst)
    assert rt == pytest.approx(float(rj), rel=1e-3)
    assert st == pytest.approx(float(sj), rel=1e-5)
    np.testing.assert_allclose(Rt, np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt, np.asarray(tj), atol=1e-4)


@pytest.fixture(scope="module")
def small_drive():
    """60 rendered frames of bench.py's plane (240x376, 500 features over 4
    levels) through `track_monocular` alone on the CPU."""
    cfg = ss.SceneConfig(hw=(240, 376), K4=(400.0, 400.0, 188.0, 120.0),
                         orb=H.SMALL.orb, capacity=H.SMALL.capacity, seed_frames=(),
                         track_frames=tuple(range(60)), view_points=2048,
                         ba_caps=(8, 1024, 4096), new_pt_budget=256)
    sys_, drive = ss.drive_system(cfg, ss.render_frames(cfg), "cpu")
    return cfg, sys_, drive


def test_system_boots_from_raw_frames_small(small_drive):
    """60 rendered frames (240x376, 500 features over 4 levels) through
    `track_monocular` alone on the CPU.  The small image sees less of the
    plane, so initialization takes until about frame 30; the other gates
    are the full-size ones."""
    cfg, sys_, drive = small_drive
    bad, stats = ss.check_system_gates(sys_, drive, init_by=40)
    assert bad == []
    assert stats["init"]["used_homography"]      # the scene is a plane
    assert stats["n_kf"] >= 5 and sys_.map.kf_R.device.type == "cpu"


def test_plane_candidates_jax_reflects_where_the_port_rotates(small_drive, monkeypatch):
    """The smoke run's relocalization phase at the small size, on the CPU,
    with its gates; and the candidate sets of its recovering attempt (each
    admitted keyframe's matched plane points) given to the JAX `solve_mlpnp`
    as well, the port with the samples JAX drew.  The port returns a rotation
    for every candidate.  Where JAX returns a rotation too, the inlier sets
    are identical, R agrees within 1e-4 and t within 1e-3 relative.  For at
    least one candidate JAX returns a reflection (det -1): the port's
    rotation times the mirror through the plane.  The map's points are not
    exactly coplanar and the mirror moves each by twice its distance from
    the plane, so there the inliers land within 5e-2 of the scene's unit of
    where the port puts them and the inlier counts agree within 3."""
    import jax
    from orbslam3_tpu.geometry import mlpnp as jmlpnp
    from orbslam3_tpu_torch.geometry import mlpnp as tmlpnp
    cfg, sys_, drive = small_drive
    calls = []

    def recording(X, uv, valid, cam_model, cam_params, **kw):
        res = solve(X, uv, valid, cam_model, cam_params, **kw)
        calls.append((X, uv, valid, cam_params, kw["inv_sigma2"], res))
        return res

    solve = tmlpnp.solve_mlpnp
    monkeypatch.setattr(tmlpnp, "solve_mlpnp", recording)
    f0 = drive.frames[drive.init_frame]
    d = ss.drive_relocalization(sys_, cfg, tuple(range(f0 + 3, f0 + 9)), "cpu")
    assert ss.check_reloc_gates(sys_, d, 0) == []
    X, uv, ok, cam, is2, won = calls[-1]          # the attempt that recovered
    assert bool(won.success.any())
    admitted = [c for c in range(X.shape[0]) if bool(ok[c].any())]
    assert len(admitted) >= 3
    keys = jax.random.split(jax.random.PRNGKey(0), X.shape[0])
    n_reflected = 0
    for c in admitted:
        Xc, okc = X[c].numpy(), ok[c].numpy()
        rj = jmlpnp.solve_mlpnp(jnp.asarray(Xc), jnp.asarray(uv.numpy()), jnp.asarray(okc),
                                "pinhole", jnp.asarray(cam.numpy()), keys[c], iterations=300,
                                min_inliers=30, inv_sigma2=jnp.asarray(is2.numpy()))
        idx = H.jax_mlpnp_samples(keys[c], okc, is2.numpy(), 300)
        rt = solve(X[c], uv, ok[c], "pinhole", cam, idx=torch.from_numpy(idx.copy()),
                   iterations=300, min_inliers=30, inv_sigma2=is2)
        Rj, tj = np.asarray(rj.R), np.asarray(rj.t)
        assert np.linalg.det(rt.R.numpy()) == pytest.approx(1.0, abs=1e-4)
        assert bool(rt.success) == bool(rj.success)
        on = np.asarray(rj.inliers)
        if np.linalg.det(Rj) < 0:
            n_reflected += 1
            assert np.linalg.det(Rj) == pytest.approx(-1.0, abs=1e-4)
            assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 3
            assert np.abs((Xc[on] @ Rj.T + tj)
                          - (Xc[on] @ rt.R.numpy().T + rt.t.numpy())).max() < 5e-2
        else:
            np.testing.assert_array_equal(rt.inliers.numpy(), on)
            np.testing.assert_allclose(rt.R.numpy(), Rj, atol=1e-4)
            np.testing.assert_allclose(rt.t.numpy(), tj, atol=1e-3 * float(np.linalg.norm(tj)))
    assert n_reflected >= 1


@pytest.mark.slow
def test_system_boots_from_raw_frames_full_size():
    """bench.py's 78 frames at the default configuration through
    `track_monocular` alone, on the CPU, with the gates of the smoke run's
    system phase."""
    cfg = dataclasses.replace(ss.SceneConfig(), seed_frames=(), track_frames=tuple(range(78)))
    sys_, drive = ss.drive_system(cfg, ss.render_frames(cfg), "cpu")
    bad, stats = ss.check_system_gates(sys_, drive)
    assert bad == []
    assert stats["init"]["used_homography"]      # the scene is a plane
