"""The port's mono-inertial `System` against the JAX package's.

Fed features, as `tests/test_inertial_pipeline.py` feeds them
(`SyntheticWorld` on `camera_path_smooth`, 20 frames per second, a 200 Hz
IMU read at each sample interval's midpoint), at a small map capacity.  One
JAX `InertialSystem` drives itself through the IMU initialization and a few
frames past it; the state it had before its first IMU initialization, its
first LastKeyFrame and LastFrame tracked frames and its first inertial
keyframe is recorded (`torch_parity_helpers.inertial_snapshot`).  The port's
`InertialSystem` is given each recorded state
(`torch_parity_helpers.load_inertial_snapshot`, `convert.set_inertial_state`)
and runs the same step on the same inputs; the results are held to the JAX
system's.  MergePrevious runs on both from the same raw buffers, and the
monocular `System`'s hooks for the inertial subclass are checked to leave it
as it was.  The port's whole drive of test_inertial_pipeline.py, alone, is
marked slow as its JAX twin is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import inertial_system as jis
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.slam_map import feature_bank as jbank
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu.solver import inertial as jinertial
from orbslam3_tpu.solver import vi_pose_opt as jvpo
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map import state as tstate
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.solver import inertial as tinertial
from orbslam3_tpu_torch.utils import align as talign
from test_inertial_pipeline import FPS, G, IMU_HZ, camera_path_smooth
from test_pipeline_e2e import HW, K4, SyntheticWorld

torch.set_num_threads(2)

CAP = dict(n_kf=32, n_pt=4096, n_obs=32768)
COMMON = dict(cam_params=K4, image_hw=HW, min_init_matches=80, max_frames_between_kf=6,
              ba_caps=(16, 2048, 8192), local_view_points=2048, new_pt_budget=256,
              enable_relocalization=False)
ICOMMON = dict(imu_freq=IMU_HZ, init_time_s=1.5, init_min_kfs=5, fiba_cams=32)
N_FRAMES = 42


def _tsys():
    return tis.InertialSystem(
        tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **COMMON),
        tis.InertialConfig(**ICOMMON), device="cpu")


def _imu_samples(i, rot, rot_rate, acc):
    """test_inertial_pipeline's samples over ((i-1)/FPS, i/FPS]."""
    out = []
    if i == 0:
        return out
    dt_f, dt_i = 1.0 / FPS, 1.0 / IMU_HZ
    t0, t_frame = (i - 1) * dt_f, i * dt_f
    k = 1
    while t0 + k * dt_i <= t_frame + 1e-9:
        tm = t0 + k * dt_i
        Rb = rot(tm - 0.5 * dt_i)
        out.append((tm, rot_rate(tm - 0.5 * dt_i), Rb.T @ (acc(tm - 0.5 * dt_i) - G)))
        k += 1
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX InertialSystem's drive with its recorded steps: "init" (the
    first `_initialize_imu`, with the inertial-only solution), "lastkf" and
    "lastframe" (the first tracked frames of each branch that insert no
    keyframe, with the frame's stats) and "kf" (the first keyframe inserted
    with the VI window BA)."""
    jsys = jis.InertialSystem(
        jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **COMMON),
        jis.InertialConfig(**ICOMMON))
    rec = {}
    init_imu, track, insert = jsys._initialize_imu, jsys._track_frame, jsys._insert_keyframe
    vi_step, solve = jsys._vi_track_step, jinertial.inertial_only_init
    seen = {}

    def spy_solve(*a, **kw):
        seen["init_result"] = res = solve(*a, **kw)
        return res

    def spy_init(prior_g=1e2, prior_a=1e6):
        if "init" in rec:
            return init_imu(prior_g, prior_a)
        before = H.inertial_snapshot(jsys)
        jinertial.inertial_only_init = spy_solve
        try:
            ok = init_imu(prior_g, prior_a)
        finally:
            jinertial.inertial_only_init = solve
        rec["init"] = dict(before=before, args=(prior_g, prior_a), ok=ok,
                           res=H.fields(seen["init_result"]), after=H.inertial_snapshot(jsys))
        return ok

    def spy_step(*a):
        seen["out"] = out = vi_step(*a)
        return out

    def spy_track(ff, ts):
        inertial = jsys.imu_initialized and jsys.last_body is not None and \
            jsys._frame_rows is not None
        kind = ("lastkf" if jsys._map_updated or jsys.frame_prior is None else "lastframe") \
            if inertial else None
        before = H.inertial_snapshot(jsys) if kind and kind not in rec else None
        n_kf = jsys.n_kf_host
        track(ff, ts)
        if before is not None and jsys.n_kf_host == n_kf:
            m2, out = seen["out"]
            rec[kind] = dict(before=before, ff=H.fields(ff), ts=ts,
                             stats=np.asarray(out.stats), after=H.inertial_snapshot(jsys))

    def spy_insert(ff, tr, ts, n_inl=None):
        if "kf" in rec or not jsys.imu_initialized:
            return insert(ff, tr, ts, n_inl=n_inl)
        before = H.inertial_snapshot(jsys)
        insert(ff, tr, ts, n_inl=n_inl)
        rec["kf"] = dict(before=before, ff=H.fields(ff), ts=ts, n_inl=n_inl,
                         tr={k: np.asarray(getattr(tr, k)) for k in ("kp_pt", "R", "t")},
                         after=H.inertial_snapshot(jsys))

    jsys._initialize_imu, jsys._track_frame, jsys._insert_keyframe = \
        spy_init, spy_track, spy_insert
    jsys._vi_track_step = spy_step
    world = SyntheticWorld(seed=3)
    frames, pos, vel, acc, rot, rot_rate = camera_path_smooth(N_FRAMES)
    for i in range(N_FRAMES):
        for s in _imu_samples(i, rot, rot_rate, acc):
            jsys.grab_imu(*s)
        jsys.track_monocular(None, ts=i / FPS, features=world.frame(*frames[i][:2]))
        if all(k in rec for k in ("init", "lastkf", "lastframe", "kf")):
            break
    assert jsys.n_resets == 0 and jsys.imu_initialized
    assert all(k in rec for k in ("init", "lastkf", "lastframe", "kf")), sorted(rec)
    return rec


def _loaded(snap, Tbc=()):
    tsys = _tsys() if not Tbc else tis.InertialSystem(
        tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **COMMON),
        tis.InertialConfig(**ICOMMON, Tbc=Tbc), device="cpu")
    H.load_inertial_snapshot(snap, tsys)
    return tsys


def _jax_loaded(snap, Tbc=()):
    """A JAX InertialSystem given what `_schedule_gba` and `_merge_pending`
    read of a snapshot: map, bank, factors, tracker, velocity, bias, prior."""
    jsys = jis.InertialSystem(jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **COMMON),
                              jis.InertialConfig(**ICOMMON, Tbc=Tbc))
    jsys.map = jstate.MapState(**{k: jnp.asarray(v) for k, v in snap["map"].items()})
    jsys.bank = jbank.FeatureBank(**{k: jnp.asarray(v) for k, v in snap["bank"].items()})
    jsys.preints = [jimu.Preintegrated(**{k: jnp.asarray(v) for k, v in p.items()})
                    for p in snap["preints"]]
    jsys.preint_kf_pairs = list(snap["preint_kf_pairs"])
    for name in ("R_cur", "t_cur", "R_prev", "t_prev", "vel", "bias"):
        setattr(jsys, name, jnp.asarray(snap[name]))
    for name in ("last_kf_idx", "n_kf_host", "imu_initialized", "has_velocity"):
        setattr(jsys, name, snap[name])
    fp = snap["frame_prior"]
    jsys.frame_prior = None if fp is None else jvpo.VIPosePrior(
        **{k: jnp.asarray(v) for k, v in fp.items()})
    return jsys


# a camera-body extrinsic of ~0.1 rad and 7 cm (EuRoC's is not the identity)
TBC = tuple(np.block([[np.asarray(jlie.exp_so3(jnp.asarray([0.05, -0.07, 0.04]))),
                       np.array([[0.05], [-0.04], [0.03]])],
                      [np.zeros((1, 3)), np.ones((1, 1))]]).astype(np.float64).reshape(-1))


@pytest.mark.parametrize("Tbc", [(), TBC], ids=["identity", "extrinsic"])
def test_post_loop_full_inertial_ba_matches_jax(jax_run, Tbc):
    """After a loop closure on an IMU-initialized map `_schedule_gba` posts
    the full inertial BA over every factor (on the CPU it runs inline), and
    the forced "gba" merge carries the tracker: from the JAX system's state
    after its first inertial keyframe, with the identity extrinsic and with
    one of ~0.1 rad and 7 cm, the pending map (keyframe poses, velocities
    and biases within 1e-3, points within 1e-3 of the map's extent) and the
    merged tracker (pose and velocity within 1e-3, the prior dropped)."""
    snap = jax_run["kf"]["after"]
    ki = snap["last_kf_idx"]
    js, ts = _jax_loaded(snap, Tbc), _loaded(snap, Tbc)
    js._schedule_gba(ki)
    ts._schedule_gba(ki)
    assert ts._pending.kind == "gba" and ts.chain_counts["posted gba"] == 1
    got, ref = convert.to_numpy(ts._pending.m_opt), H.fields(js._pending[0])
    k = _valid_kfs(snap)
    for name in ("kf_R", "kf_t", "kf_vel", "kf_bias"):
        np.testing.assert_allclose(got[name][k], ref[name][k], atol=1e-3, err_msg=name)
    p = ref["pt_valid"]
    assert np.abs(got["pt_xyz"][p] - ref["pt_xyz"][p]).max() < 1e-3 * np.abs(ref["pt_xyz"][p]).max()
    assert np.abs(ref["kf_t"][k] - snap["map"]["kf_t"][k]).max() > 1e-4     # it moved
    js._merge_pending(force=True)
    ts._merge_pending(force=True)
    for name in ("R_cur", "t_cur", "vel"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=1e-3, err_msg=name)
    assert ts.frame_prior is None and js.frame_prior is None and ts._map_updated


def _valid_kfs(snap):
    return np.nonzero(snap["map"]["kf_valid"])[0]


def _check_map(tsys, after, pose_tol, point_tol, vb_tol):
    """Keyframe poses within pose_tol, velocities and biases within vb_tol,
    points within point_tol relative to the map's extent; the same valid
    keyframes and points."""
    m, ref = convert.to_numpy(tsys.map), after["map"]
    np.testing.assert_array_equal(m["kf_valid"], ref["kf_valid"])
    np.testing.assert_array_equal(m["pt_valid"], ref["pt_valid"])
    k = _valid_kfs(after)
    for name in ("kf_R", "kf_t"):
        np.testing.assert_allclose(m[name][k], ref[name][k], rtol=0, atol=pose_tol, err_msg=name)
    for name in ("kf_vel", "kf_bias"):
        np.testing.assert_allclose(m[name][k], ref[name][k], rtol=0, atol=vb_tol, err_msg=name)
    p = ref["pt_valid"]
    scale = np.abs(ref["pt_xyz"][p]).max()
    assert np.abs(m["pt_xyz"][p] - ref["pt_xyz"][p]).max() < point_tol * scale


def test_initialize_imu_matches_jax(jax_run):
    """The first IMU initialization from the JAX system's state before it:
    the inertial-only solution (scale within 1e-3 relative, Rwg and bias
    within 1e-4), then the re-anchored, reintegrated and FullInertialBA'd map
    (keyframe poses within 1e-3, velocities and biases within 1e-3, points
    within 1e-3 of the map's extent), the tracker's velocity and bias."""
    r = jax_run["init"]
    tsys = _loaded(r["before"])
    seen = {}
    solve = tinertial.inertial_only_init

    def spy(*a, **kw):
        seen["res"] = res = solve(*a, **kw)
        return res

    tinertial.inertial_only_init = spy
    try:
        ok = tsys._initialize_imu(*r["args"])
    finally:
        tinertial.inertial_only_init = solve
    assert ok and r["ok"] and tsys.imu_initialized
    res, ref = seen["res"], r["res"]
    assert abs(float(res.scale) - float(ref["scale"])) < 1e-3 * float(ref["scale"])
    np.testing.assert_allclose(res.Rwg.numpy(), ref["Rwg"], atol=1e-4)
    np.testing.assert_allclose(res.bias.numpy(), ref["bias"], atol=1e-4)
    _check_map(tsys, r["after"], pose_tol=1e-3, point_tol=1e-3, vb_tol=1e-3)
    np.testing.assert_allclose(tsys.bias.numpy(), r["after"]["bias"], atol=1e-3)
    np.testing.assert_allclose(tsys.vel.numpy(), r["after"]["vel"], atol=1e-3)
    assert tsys.preint_kf_pairs == r["after"]["preint_kf_pairs"]
    for p, q in zip(tsys.preints, r["after"]["preints"]):
        np.testing.assert_allclose(p.dV.numpy(), q["dV"], atol=1e-4)
        np.testing.assert_allclose(p.b.numpy(), q["b"], atol=1e-4)


@pytest.mark.parametrize("branch", ["lastkf", "lastframe"])
def test_fused_tracked_frame_matches_jax(jax_run, branch):
    """One inertial tracked frame in each branch (LastKeyFrame right after
    the map update, then the LastFrame chain under the carried prior), from
    the JAX system's state before it: the same inlier count, vi_ok and
    bindings, the camera pose within 1e-4 and the velocity within 1e-3, the
    next frame's prior within 1e-3 relative."""
    r = jax_run[branch]
    tsys = _loaded(r["before"])
    ff = convert.frame_from_numpy(r["ff"])
    tsys._track_frame(ff, r["ts"])
    assert tsys.last_vi_branch == branch
    st, ref = tsys.last_vi_stats, r["stats"]
    assert int(st[0]) == int(ref[0]) and bool(st[1]) == bool(ref[1]) and bool(st[1])
    assert int(st[2]) == int(ref[2])
    after = r["after"]
    np.testing.assert_allclose(tsys.R_cur.numpy(), after["R_cur"], atol=1e-4)
    np.testing.assert_allclose(tsys.t_cur.numpy(), after["t_cur"], atol=1e-4)
    np.testing.assert_allclose(tsys.vel.numpy(), after["vel"], atol=1e-3)
    assert tsys._map_updated == after["_map_updated"]
    H_ref = after["frame_prior"]["H"]
    H_got = tsys.frame_prior.H.numpy()
    assert np.abs(H_got - H_ref).max() < 1e-3 * np.abs(H_ref).max()
    m, mr = convert.to_numpy(tsys.map), after["map"]
    np.testing.assert_array_equal(m["pt_found"], mr["pt_found"])
    np.testing.assert_array_equal(m["pt_visible"], mr["pt_visible"])


def test_inertial_keyframe_matches_jax(jax_run):
    """The first keyframe inserted with the VI window BA, from the JAX
    system's state before it: the same keyframe slot, bindings and valid
    points, the preintegration chain extended with the same pair, keyframe
    poses within 1e-4, velocities and biases within 1e-3, points within 1e-3
    of the map's extent."""
    r = jax_run["kf"]
    tsys = _loaded(r["before"])
    import types
    tr = types.SimpleNamespace(**{k: torch.from_numpy(np.array(v)) for k, v in r["tr"].items()})
    tsys._insert_keyframe(convert.frame_from_numpy(r["ff"]), tr, r["ts"], r["n_inl"])
    after = r["after"]
    assert tsys.n_kf_host == after["n_kf_host"] and tsys.last_kf_idx == after["last_kf_idx"]
    assert tsys.preint_kf_pairs == after["preint_kf_pairs"]
    np.testing.assert_array_equal(tsys.bank.kp_pt.numpy(), after["bank"]["kp_pt"])
    _check_map(tsys, after, pose_tol=1e-4, point_tol=1e-3, vb_tol=1e-3)
    np.testing.assert_array_equal(tsys.view.idx.numpy(), after["view"]["idx"])


def _merge_setup(sys_, map_fn, n_kf):
    """TestMergePrevious's setup: n_kf keyframes, factors between them from
    numpy-made raw buffers."""
    rng = np.random.default_rng(0)
    pairs = [(i, i + 1) for i in range(n_kf - 1)]
    raws = []
    for _ in pairs:
        n = 40
        acc = rng.normal(0, 0.1, (n, 3)).astype(np.float32) + np.array([0, 0, 9.81], np.float32)
        gyr = rng.normal(0, 0.01, (n, 3)).astype(np.float32)
        raws.append((acc, gyr, np.full(n, 1.0 / IMU_HZ, np.float32)))
    sys_.map = map_fn()
    for p, raw in zip(pairs, raws):
        sys_.preints.append(sys_._preint_raw(*raw, sys_.bias))
        sys_.preint_kf_pairs.append(p)
        sys_.preint_raw.append(raw)


@pytest.mark.parametrize("n_kf, culled", [(3, 1), (2, 1)])
def test_cull_keyframe_merges_previous_as_jax(n_kf, culled):
    """MergePrevious on a culled keyframe between two factors (one spanning
    factor, its dT the sum, its deltas those of the concatenated raw
    buffers, within 1e-5 of JAX's) and at the end of the chain (the factor
    dropped), as tests/test_inertial_chain.py::TestMergePrevious."""
    jsys = jis.InertialSystem(jsystem.SlamConfig(cam_params=K4, image_hw=HW,
                                                 ba_caps=(24, 4096, 16384),
                                                 enable_relocalization=False),
                              jis.InertialConfig(imu_freq=IMU_HZ))
    tsys = tis.InertialSystem(tsystem.SlamConfig(cam_params=K4, image_hw=HW,
                                                 ba_caps=(24, 4096, 16384),
                                                 enable_relocalization=False),
                              tis.InertialConfig(imu_freq=IMU_HZ), device="cpu")

    def jmap():
        m = jstate.empty_map(jsys.cfg.map_capacity)
        for k in range(n_kf):
            m, _ = jstate.add_keyframe(m, jnp.eye(3), jnp.zeros(3), float(k), k)
        return m

    _merge_setup(jsys, jmap, n_kf)
    _merge_setup(tsys, lambda: convert.map_from_numpy(H.fields(jmap())), n_kf)
    dT0 = sum(float(p.dT) for p in tsys.preints)
    jsys._cull_keyframe(culled)
    tsys._cull_keyframe(culled)
    assert tsys.preint_kf_pairs == jsys.preint_kf_pairs
    assert len(tsys.preints) == len(jsys.preints) == len(tsys.preint_raw)
    if n_kf == 3:
        assert tsys.preint_kf_pairs == [(0, 2)]
        assert abs(float(tsys.preints[0].dT) - dT0) < 1e-5
        for k in ("dR", "dV", "dP", "dT"):
            np.testing.assert_allclose(getattr(tsys.preints[0], k).numpy(),
                                       np.asarray(getattr(jsys.preints[0], k)), atol=1e-5)
    else:
        assert tsys.preint_kf_pairs == []


def _kf_map(n_kf=9):
    m = tstate.empty_map(MapCapacity(n_kf=16, n_pt=256, n_obs=1024))
    for k in range(n_kf):
        m, _ = tstate.add_keyframe(m, torch.eye(3), torch.tensor([0.1 * k, 0.0, 0.0]),
                                   float(k), k)
    return m


def test_monocular_system_is_unchanged_by_the_inertial_hooks(monkeypatch):
    """The monocular System's keyframe step takes no BA argument of its own
    (`_window_ba` is None, the visual grid BA runs, as `kf_step(ba=None)`),
    and `post_ba_stages` returns the culled keyframe's index, which the
    System hands to its `_cull_keyframe` hook after the map and the
    database have dropped it."""
    cfg = tsystem.SlamConfig(cam_params=K4, image_hw=HW, fuse_every_n_kf=0,
                             local_view_points=128, enable_relocalization=False,
                             map_capacity=MapCapacity(n_kf=16, n_pt=256, n_obs=1024))
    sys_ = tsystem.System(cfg, device="cpu")
    assert sys_._window_ba() is None
    assert sys_._cull_keyframe(3) is None
    m = _kf_map()
    from orbslam3_tpu_torch.pipeline import fusion
    from orbslam3_tpu_torch.slam_map import feature_bank as fb
    red = torch.zeros(16, dtype=torch.bool)
    red[3] = red[5] = True
    monkeypatch.setattr(fusion, "redundancy_window", lambda m_, ki: red)
    bank = fb.empty_bank(16, 32, "cpu")
    ff_fields = {k: np.asarray(v) for k, v in H.fields(SyntheticWorld(seed=1).frame(
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32))).items()}
    ff = convert.frame_from_numpy(ff_fields)
    kp = torch.full((ff.xy.shape[0],), -1, dtype=torch.int32)
    m2, _, _, _, culled = tsystem.post_ba_stages(cfg, sys_.cam_params, m, bank, 8, ff, kp, None)
    assert culled == 3 and not bool(m2.kf_valid[3]) and bool(m2.kf_valid[5])
    _, _, _, _, none = tsystem.post_ba_stages(cfg, sys_.cam_params, m, bank, 7, ff, kp, None)
    assert none is None
    # an inertial System's keyframe step runs the visual BA until the IMU is
    # initialized, then its own
    isys = tis.InertialSystem(cfg, tis.InertialConfig(), device="cpu")
    assert isys._window_ba() is None
    isys.imu_initialized = True
    assert isys._window_ba() == isys._vi_ba_dispatch


def test_kf_step_default_ba_is_the_visual_window_ba():
    """`kf_step(ba=None)` and `kf_step` given the visual window BA itself
    give the same keyframe step, bit for bit, on the small seeded map."""
    cfg = H.SMALL
    frames = H.ss.render_frames(cfg)
    m, bank, view = H.ss.seed_map(cfg, frames, "cpu")
    m, ff, kp_pt, R, t, fi = H.ss.first_kf_inputs(cfg, m, view, frames, "cpu")
    scfg = H.ss.slam_config(cfg)
    cam = torch.tensor(cfg.K4)
    kp_ur = torch.full((ff.xy.shape[0],), -1.0)
    ki = len(cfg.seed_frames)
    args = (scfg, cam, m, bank, ff, kp_pt, R, t, fi / 10.0, fi, kp_ur, ki)
    a = tsystem.kf_step(*args)
    b = tsystem.kf_step(*args, ba=lambda m_, c, bk: tsystem.local_ba(scfg, cam, m_, c, bk))
    for x, y in zip(convert.to_numpy(a[0]).values(), convert.to_numpy(b[0]).values()):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(a[3], b[3])


@pytest.mark.slow
def test_inertial_system_alone_recovers_metric_scale():
    """test_inertial_pipeline.py's drive on the port alone (default map
    capacity, 120 frames): no reset, OK at the end, the IMU initialized, and
    after alignment with scale of the post-init half |s - 1| < 0.12 and RMSE
    < 0.1."""
    world = SyntheticWorld(seed=3)
    n_frames = 120
    frames, pos, vel, acc, rot, rot_rate = camera_path_smooth(n_frames)
    sys_ = tis.InertialSystem(
        tsystem.SlamConfig(cam_params=K4, image_hw=HW, min_init_matches=80,
                           max_frames_between_kf=6, ba_caps=(24, 4096, 16384)),
        tis.InertialConfig(imu_freq=IMU_HZ, init_time_s=1.5, init_min_kfs=5), device="cpu")
    for i in range(n_frames):
        for s in _imu_samples(i, rot, rot_rate, acc):
            sys_.grab_imu(*s)
        ff = convert.frame_from_numpy(H.fields(world.frame(*frames[i][:2])))
        sys_.track_monocular(None, ts=i / FPS, features=ff)
    assert sys_.n_resets == 0 and sys_.state == tsystem.OK and sys_.imu_initialized
    est = np.stack([p[2] for p in sys_.trajectory])
    gt = np.stack([pos(p[0]) for p in sys_.trajectory])
    half = len(est) // 2
    rmse, s, _, _ = talign.ate_rmse(est[half:], gt[half:], with_scale=True)
    assert abs(s - 1.0) < 0.12, s
    assert rmse < 0.1, rmse
