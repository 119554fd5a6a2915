"""`orbslam3_tpu_torch/bench.py` against the repository's `bench.py`.

bench.py's scenes are closures of its chain functions, so the JAX side of
each test rebuilds bench.py's inputs from the JAX package's
`utils/synth_render` exactly as bench.py:100-122, :213-262, :277-328 and
:400-415 do; the JAX package and `bench.py` are not edited.

(a) the three scenes' inputs bit-equal: frames, each frame's packed IMU rows
    and scalar vector `sc` (a LastFrame and a LastKeyFrame frame) and the
    keyframe interval's preintegration inputs;
(b) the tracking chain at 3 frames against JAX's `extract_jit` +
    `track_local_map` at radius 15 against the whole capacity: R and t
    within 1e-4, the same inliers (the random frames match nothing and
    their poses are NaN in both packages, NaN where JAX's is);
(c) the full chain's tracked frame and keyframe step on a map that the JAX
    package seeded and tracked (`torch_parity_helpers`), against JAX's
    `slam_frame` and `System._kf_step` on the same state: the same inliers
    and bindings, the pose within 1e-4; the same new points and slots,
    keyframe poses within 1e-4, points within 1e-3 relative;
(d) the inertial chain's keyframe programs on that state (bench.py:361-375:
    the keyframe interval's preintegration, insertion, culling, the factor
    stack, the keyframe's velocity and bias, the VI window BA at caps 8 /
    1024 / 4096, the view) against JAX's: the preintegration within 1e-4
    (120 float32 steps composed in another order: 1.8e-5 measured),
    keyframe poses within 1e-4, velocities and biases within 1e-3, points
    within 1e-3 of the map's extent, the same bindings and view;
(e) `main` at cut sizes on the CPU prints bench.py's keys and the port's,
    exits 1 when a chain raises, and refuses a card that is not there.

The chains at bench.py's depth on the CPU, in both packages, are slow.
"""

import dataclasses
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.pipeline import inertial_system as jis
from orbslam3_tpu.pipeline import tracking as jtracking
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu.solver import inertial as jinertial
from orbslam3_tpu.utils import synth_render as jsr
from orbslam3_tpu_torch import bench
from orbslam3_tpu_torch.features.extractor import extract
from orbslam3_tpu_torch.ops import orb_patches
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.utils import seeded_scene as ss

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (480, 752)
K4 = (400.0, 400.0, 376.0, 240.0)


def _jax_bench():
    """The repository's bench.py as a module (its top level imports no JAX)."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------- (a) the scenes, bit for bit
def _jax_full_frames(n):
    """bench.py:101-122."""
    rng = np.random.default_rng(3)
    tex = jsr.block_texture(rng, block=10)
    out = []
    for i in range(n):
        t = i / 10.0
        R_cw, t_cw = jsr.look_down_pose(0.30 * t, 0.05 * np.sin(1.7 * t), 5.0,
                                        yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))
        img = jsr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex, tex_scale=60.0)
        img += rng.normal(0, 1.5, img.shape).astype(np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _jax_pose(t):
    """bench.py:228-234."""
    return jsr.look_down_pose(0.30 * t, 0.05 * np.sin(1.7 * t), 5.0 + 0.35 * np.sin(1.2 * t),
                              yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))


def _jax_imu_at(t, h=1e-3):
    """bench.py:236-249."""
    G = np.array([0.0, 0.0, -9.81])

    def pos_w(t):
        R_cw, t_cw = _jax_pose(t)
        return -(R_cw.T @ t_cw)

    a_w = (pos_w(t + h) - 2.0 * pos_w(t) + pos_w(t - h)) / (h * h)
    R0 = _jax_pose(t)[0].T
    R1 = _jax_pose(t + h)[0].T
    dR = R0.T @ R1
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) * 0.5 / h
    return w.astype(np.float32), (R0.T @ (a_w - G)).astype(np.float32)


def _jax_inertial_frames(n):
    """bench.py:214-215, :251-257."""
    rng = np.random.default_rng(7)
    tex = jsr.block_texture(rng, block=10)
    out = []
    for i in range(n):
        R_cw, t_cw = _jax_pose(i / 10.0)
        img = jsr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex, tex_scale=60.0)
        img += rng.normal(0, 1.5, img.shape).astype(np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _jax_staging(warmup, measure, last_kf_t, ki_host, capF, capK, min_inl, kf_every=6):
    """bench.py:278-328 with numpy arrays in place of the device copies:
    (packed, sc, kf_pre) per measured frame."""
    FPS, dt_i = 10.0, 1.0 / 200.0
    kf_sched = [((i - warmup) % kf_every == kf_every - 1)
                for i in range(warmup, warmup + measure)]
    packed_l, sc_l, kf_pre = [], [], {}
    imu_all = []
    tcur = (warmup - 1) / FPS
    while tcur + dt_i <= (warmup + measure - 1) / FPS + 1e-9:
        tcur += dt_i
        w, a = _jax_imu_at(tcur - 0.5 * dt_i)
        imu_all.append((tcur, w, a))
    prev_kf_ts = last_kf_t
    kf_count = 0
    for n, i in enumerate(range(warmup, warmup + measure)):
        t1, t0 = i / FPS, (i - 1) / FPS
        take = [s for s in imu_all if t0 < s[0] <= t1]
        steps = jis.reference_imu_steps(take, t0, t1)
        packed = np.zeros((capF + capK, 8), np.float32)
        packed[:capF] = jis.pack_imu_rows(steps, capF)
        after_kf = (n > 0 and kf_sched[n - 1])
        if after_kf:
            takeK = [s for s in imu_all if prev_kf_ts < s[0] <= t1]
            packed[capF:] = jis.pack_imu_rows(jis.reference_imu_steps(takeK, prev_kf_ts, t1),
                                              capK)
        ki_at = ki_host + kf_count - 1
        sc_l.append(np.asarray([12.0 if after_kf else 4.0, min_inl, 1.0 if after_kf else 0.0,
                                1.0, max(ki_at, 0), 0, 0, 0], np.float32))
        packed_l.append(packed)
        if kf_sched[n]:
            takeB = [s for s in imu_all if prev_kf_ts < s[0] <= t1]
            acc, gyr, dts = jis.reference_imu_steps(takeB, prev_kf_ts, t1)
            nB = min(len(acc), capK)
            a4 = np.zeros((capK, 3), np.float32)
            g4 = np.zeros((capK, 3), np.float32)
            d4 = np.zeros(capK, np.float32)
            m4 = np.zeros(capK, bool)
            a4[:nB], g4[:nB], d4[:nB], m4[:nB] = acc[:nB], gyr[:nB], dts[:nB], True
            kf_pre[n] = (a4, g4, d4, m4)
            prev_kf_ts = t1
            kf_count += 1
    return packed_l, sc_l, kf_pre


def test_scenes_bit_equal_to_bench_py():
    rng = np.random.default_rng(0)                               # bench.py:400-405
    for a, b in zip(bench.tracking_images(3),
                    [rng.integers(0, 255, (480, 752), dtype=np.uint8) for _ in range(3)]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(bench.full_frames(3), _jax_full_frames(3)):
        np.testing.assert_array_equal(a, b)
    r = bench.vi_scene.Renderer()
    for i, b in enumerate(_jax_inertial_frames(3)):
        np.testing.assert_array_equal(r[i], b)
    for t in (0.0, 7.3, 12.75):
        for a, b in zip(bench.vi_scene.imu_at(t), _jax_imu_at(t)):
            np.testing.assert_array_equal(a, b)


def test_imu_staging_bit_equal_to_bench_py():
    """The staged rows of a LastFrame frame (the first), a keyframe frame
    (the 6th) and the LastKeyFrame frame after it, after a warm-up of 106
    frames with the last keyframe at 10.1 s and 18 keyframes."""
    icfg = bench.inertial_config()
    capF = icfg.max_imu_per_frame
    capK = capF * icfg.preint_buf_factor
    args = (106, 14, 10.1, 18, capF, capK, 20)
    got = bench.stage_imu(*args)
    packed, sc, kf_pre = _jax_staging(*args)
    assert len(got) == len(packed) == 14
    for n in (0, 5, 6, 11, 12):
        np.testing.assert_array_equal(got[n].packed, packed[n], err_msg=str(n))
        np.testing.assert_array_equal(got[n].sc, sc[n], err_msg=str(n))
        assert (got[n].kf_rows is None) == (n not in kf_pre)
    assert sc[0][2] == 0.0 and sc[6][2] == 1.0 and sc[6][0] == 12.0 and sc[6][4] == 18.0
    assert int((packed[6][capF:, 7] > 0).sum()) > 0
    for n, (a4, g4, d4, m4) in kf_pre.items():
        rows = got[n].kf_rows
        np.testing.assert_array_equal(rows[:, 0:3], a4)
        np.testing.assert_array_equal(rows[:, 3:6], g4)
        np.testing.assert_array_equal(rows[:, 6], d4)
        np.testing.assert_array_equal(rows[:, 7] > 0.5, m4)


# ------------------------------------------------------ (b) the tracking chain
def test_tracking_chain_matches_jax():
    """bench.py:407-437 at 3 frames: the map from the first image, one warm
    call, then the chain from the identity."""
    iters = 3
    res = bench.bench_tracking_chain("cpu", iters=iters)
    p = jx.OrbParams(n_features=1200, n_levels=8)
    cam = jnp.asarray([458.654, 457.296, 367.215, 248.375], jnp.float32)
    imgs = [jnp.asarray(x) for x in bench.tracking_images(iters)]
    ff0 = jx.extract_jit(imgs[0], p)
    m = jstate.empty_map(jstate.MapCapacity(n_kf=64, n_pt=8192, n_obs=65536))
    rays = jnp.concatenate([(ff0.xy - cam[2:4]) / cam[0:2], jnp.ones((ff0.xy.shape[0], 1))], 1)
    m, _ = jstate.add_points(
        m, rays * 5.0, ff0.desc, rays / jnp.linalg.norm(rays, axis=1, keepdims=True),
        jnp.full(ff0.xy.shape[0], 2.0), jnp.full(ff0.xy.shape[0], 10.0), 0, 0, ff0.valid)

    @jax.jit
    def frame_step(img, R_guess, t_guess):
        ff = jx.extract_jit(img, p)
        tr = jtracking.track_local_map(m, ff, R_guess, t_guess, "pinhole", cam, (480, 752),
                                       radius_th=jnp.asarray(15.0))
        return tr.R, tr.t, tr.n_inliers

    R, t = jnp.eye(3), jnp.zeros(3)
    assert len(res.frames) == iters and res.keyframes == 0 and res.reads is None
    for i, (fi, Rt, tt, n_t) in enumerate(res.frames):
        R, t, n_j = frame_step(imgs[i], R, t)
        assert fi == i and n_t == int(n_j), (i, n_t, int(n_j))
        np.testing.assert_allclose(Rt, np.asarray(R), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tt, np.asarray(t), atol=1e-4, rtol=0)
    assert res.frames[0][3] > 200          # the first image is the map's
    # the random frames match nothing: their poses are NaN in both packages
    assert [np.isfinite(R).all() for _, R, _, _ in res.frames] == [True, False, False]
    assert bench.tracking_faults(res) == []
    assert res.fps > 0 and np.isclose(res.ms_per_frame, 1e3 / res.fps)


# --------------------------------------- (c), (d) the full and inertial steps
SMALL = dataclasses.replace(H.SMALL, track_frames=tuple(range(19, 25)), ba_caps=(8, 1024, 4096),
                            new_pt_budget=256)


@pytest.fixture(scope="module")
def jax_state():
    """A map the JAX package seeded and tracked to the frame before frame
    24, and JAX's own tracked frame 24 (bench.py's `slam_frame`)."""
    cfg = SMALL
    frames = ss.render_frames(cfg)
    m, bank, view = H.seed_map_jax(cfg, frames)
    step = H._jax_frame_step(cfg)
    R_prev, t_prev = H._pose(17)
    R_cur, t_cur = H._pose(18)
    for fi in cfg.track_frames[:-1]:
        m, _, R, t, _, _ = step(m, view, jnp.asarray(frames[fi]), R_prev, t_prev, R_cur, t_cur)
        R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
    pre = dict(m=m, bank=bank, view=view, R_prev=R_prev, t_prev=t_prev, R_cur=R_cur, t_cur=t_cur)
    fi = cfg.track_frames[-1]
    out = step(m, view, jnp.asarray(frames[fi]), R_prev, t_prev, R_cur, t_cur)
    return cfg, frames, fi, pre, out


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _full_state(pre, ki):
    return bench.FullState(convert.map_from_numpy(H.fields(pre["m"])),
                           convert.bank_from_numpy(H.fields(pre["bank"])),
                           convert.view_from_numpy(H.fields(pre["view"])),
                           *(_t(pre[k]) for k in ("R_prev", "t_prev", "R_cur", "t_cur")), ki)


def test_full_chain_step_matches_jax(jax_state):
    """bench.py's `slam_frame` and `_kf_step` (bench.py:162-174) at frame 24
    of the JAX-seeded map: `FullChain.track` from JAX's state before it and
    `FullChain.keyframe` from JAX's state after it."""
    cfg, frames, fi, pre, (m_j, ff_j, R_j, t_j, kp_j, n_j) = jax_state
    ki = len(cfg.seed_frames)
    chain = bench.FullChain(ss.slam_config(cfg), torch.tensor(cfg.K4), [], 0)
    st, kp_t, n_t = chain.track(_full_state(pre, ki), extract(torch.from_numpy(frames[fi]),
                                                              cfg.orb))
    assert int(n_t) == int(n_j) > 100
    np.testing.assert_array_equal(kp_t.numpy(), _np(kp_j))
    np.testing.assert_allclose(st.R_cur.numpy(), np.asarray(R_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(st.t_cur.numpy(), np.asarray(t_j), atol=1e-4, rtol=0)
    # the keyframe step from JAX's tracked state, as JAX's _kf_step takes it
    st_j = st._replace(m=convert.map_from_numpy(H.fields(m_j)), R_cur=_t(R_j), t_cur=_t(t_j))
    st2, got = chain.keyframe(st_j, convert.frame_from_numpy(H.fields(ff_j)), _t(kp_j), fi)
    ref = H.kf_step_jax(H.jax_system(cfg), m_j, pre["bank"], ff_j, kp_j, R_j, t_j, fi, ki)
    ref = (convert.map_from_numpy(H.fields(ref[0])), convert.bank_from_numpy(H.fields(ref[1])),
           *(_t(x) for x in ref[2:5]), convert.view_from_numpy(H.fields(ref[5])))
    bad, stats = ss.kf_step_mismatch(ref, got, _t(kp_j))
    assert bad == [], (bad, stats)
    assert stats["relabelled"] == 0 and int(got[4]) > 0
    assert torch.equal(st2.view.idx, ref[5].idx)
    assert st2.ki == ki + 1 and st2.R_cur is st_j.R_cur


def _seeded_imu_at(t, h=1e-3):
    """A numeric IMU along seeded_scene's path (camera == body), as
    bench.py:240-249 makes one along its own."""
    G = np.array([0.0, 0.0, -9.81])
    pose = lambda s: ss.bench_pose(s * 10.0)
    pos_w = lambda s: -(pose(s)[0].T.astype(np.float64) @ pose(s)[1].astype(np.float64))
    a_w = (pos_w(t + h) - 2.0 * pos_w(t) + pos_w(t - h)) / (h * h)
    R0, R1 = pose(t)[0].T.astype(np.float64), pose(t + h)[0].T.astype(np.float64)
    dR = R0.T @ R1
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) * 0.5 / h
    return w.astype(np.float32), (R0.T @ (a_w - G)).astype(np.float32)


def _interval_rows(t0, t1, cap):
    dt_i = 1.0 / 200.0
    take, k = [], 1
    while t0 + k * dt_i <= t1 + 1e-9:
        tm = t0 + k * dt_i
        take.append((tm, *_seeded_imu_at(tm - 0.5 * dt_i)))
        k += 1
    return tis.pack_imu_rows(tis.reference_imu_steps(take, t0, t1), cap)


def test_inertial_keyframe_programs_match_jax(jax_state):
    """bench.py:361-375 at keyframe 4 (frame 24) of the seeded map, with the
    seed keyframes' velocities from the path, a small bias and factors of a
    numeric IMU along the path between the seed keyframes."""
    cfg, frames, fi, pre, (m_j, ff_j, R_j, t_j, kp_j, _) = jax_state
    ki = len(cfg.seed_frames)
    scfg = dataclasses.replace(ss.slam_config(cfg), enable_relocalization=False)
    icfg = bench.inertial_config()
    capK = icfg.max_imu_per_frame * icfg.preint_buf_factor
    bias = np.array([0.002, -0.001, 0.001, 0.02, -0.01, 0.015], np.float32)
    kf_frames = list(cfg.seed_frames) + [fi]
    vel = {}
    for k, f in enumerate(kf_frames):
        p = lambda s: -(ss.bench_pose(s)[0].T @ ss.bench_pose(s)[1])
        vel[k] = ((p(f + 0.01) - p(f - 0.01)) / 0.002).astype(np.float32)
    rows = [_interval_rows(a / 10.0, b / 10.0, capK) for a, b in zip(kf_frames, kf_frames[1:])]
    n_rows = [tis._n_rows(r) for r in rows]

    # JAX: the InertialSystem's programs in bench.py's order
    jsys = jis.InertialSystem(H.jax_config(scfg), H.jax_config(icfg))
    m0 = m_j._replace(kf_vel=m_j.kf_vel.at[:ki].set(np.stack([vel[k] for k in range(ki)])),
                      kf_bias=m_j.kf_bias.at[:ki].set(np.tile(bias, (ki, 1))))
    jb = jnp.asarray(bias)

    def jpre(r):
        return jsys._preint_kf(jnp.asarray(r[:, 0:3]), jnp.asarray(r[:, 3:6]),
                               jnp.asarray(r[:, 6]), jnp.asarray(r[:, 7] > 0.5), jb)

    preints = [jpre(r) for r in rows]
    pairs = [(k, k + 1) for k in range(ki)]
    kp_ur = jnp.full(ff_j.xy.shape[0], -1.0, jnp.float32)
    m, bank, _, _, _ = jsys._insert_kf_jit(m0, pre["bank"], ff_j, kp_j, R_j, t_j,
                                          jnp.asarray(fi / 10.0, jnp.float32),
                                          jnp.asarray(fi, jnp.int32), kp_ur)
    m = jsys._cull(m, jnp.asarray(fi, jnp.int32))
    capW = icfg.vi_window_factors
    f = jinertial.stack_preints_device(preints[-capW:], [q[0] for q in pairs[-capW:]],
                                       [q[1] for q in pairs[-capW:]], capacity=capW)
    ki_dev = jnp.asarray(ki, jnp.int32)
    m = jsys._set_kf_vb(m, ki_dev, jnp.asarray(vel[ki]), jb)
    m = jsys._vi_local_ba(m, ki_dev, f, bank)
    view = jsys._gather_view(m, ki_dev)

    # the port: InertialChain.keyframe from the same state
    tsys = tis.InertialSystem(scfg, icfg, device="cpu")
    tsys.bias = torch.from_numpy(bias)
    own = [tsys._preint_rows(torch.from_numpy(r[:n]), n, tsys.bias)
           for r, n in zip(rows[:-1], n_rows[:-1])]
    st = bench.InertialState(convert.map_from_numpy(H.fields(m0)),
                             convert.bank_from_numpy(H.fields(pre["bank"])), None, None, None,
                             torch.from_numpy(vel[ki]), None, tuple(own),
                             tuple(pairs[:-1]), ki)
    f_dev = bench._ImuDev(None, 0, 0, False, 4.0, ki - 1, torch.from_numpy(rows[-1]), n_rows[-1])
    out = types.SimpleNamespace(kp_pt=_t(kp_j), R_tr=_t(R_j), t_tr=_t(t_j))
    chain = bench.InertialChain(tsys, [], [], 0)
    got = chain.keyframe(st, convert.frame_from_numpy(H.fields(ff_j)), out, f_dev, fi)

    assert got.ki == ki + 1 and got.pairs == tuple(pairs)
    for k in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C"):
        np.testing.assert_allclose(getattr(got.preints[-1], k).numpy(),
                                   np.asarray(getattr(preints[-1], k)), atol=1e-4, err_msg=k)
    mt, mr = convert.to_numpy(got.m), H.fields(m)
    for k in ("n_kf", "n_pt", "n_obs", "kf_valid", "pt_valid", "obs_pt", "obs_kf", "obs_valid"):
        np.testing.assert_array_equal(mt[k], _np(mr[k]), err_msg=k)
    np.testing.assert_array_equal(got.bank.kp_pt.numpy(), _np(bank.kp_pt))
    kv = np.nonzero(mr["kf_valid"])[0]
    for k in ("kf_R", "kf_t"):
        np.testing.assert_allclose(mt[k][kv], mr[k][kv], atol=1e-4, rtol=0, err_msg=k)
    for k in ("kf_vel", "kf_bias"):
        np.testing.assert_allclose(mt[k][kv], mr[k][kv], atol=1e-3, rtol=0, err_msg=k)
    p = mr["pt_valid"]
    assert np.abs(mt["pt_xyz"][p] - mr["pt_xyz"][p]).max() < 1e-3 * np.abs(mr["pt_xyz"][p]).max()
    assert np.abs(mt["kf_t"][ki] - mr["kf_t"][ki]).max() <= 1e-4
    np.testing.assert_array_equal(got.view.idx.numpy(), _np(view.idx))


# --------------------------------------------------------------- (e) main
def _fake(fps, keyframes=0, **info):
    return bench.Chain(fps, keyframes, 1e3 / fps, None, [], (), None, None, info)


def test_main_at_cut_sizes_prints_bench_py_keys(monkeypatch, capsys):
    """The visual chains at cut sizes; the inertial chain's warm-up capped
    at 2 frames, so that it never initializes: bench.py's `inertial_error`
    from bench.py's first assert, and exit 1."""
    real_t, real_f, real_i = (bench.bench_tracking_chain, bench.bench_full_system,
                              bench.bench_full_inertial)
    monkeypatch.setattr(bench, "bench_tracking_chain", lambda dev: real_t(dev, iters=2))
    monkeypatch.setattr(bench, "bench_full_system", lambda dev: real_f(dev, measure=13))
    monkeypatch.setattr(bench, "bench_full_inertial", lambda dev: real_i(dev, cap=2))
    orb_patches.reset_counters()
    assert bench.main(["--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_keys = ["metric", "value", "unit", "vs_baseline", "full_slam_fps",
                "full_slam_vs_baseline", "keyframes_inserted", "full_slam_inertial_fps",
                "full_slam_inertial_vs_baseline", "inertial_keyframes_inserted", "inertial_error"]
    port_keys = ["device", "ms_per_frame", "host_reads_per_frame", "inertial_warmup_frames",
                 "imu_init_frame"]
    assert list(out) == jax_keys + port_keys
    assert out["metric"] == "mono_tracking_frames_per_second" and out["unit"] == "fps"
    # vs_baseline is rounded from the unrounded fps, as bench.py:471-473 does:
    # within half a unit of its last place of that fps / 33 (1e3 /
    # ms_per_frame; the rounded `value` can sit across a rounding edge)
    fps = 1e3 / out["ms_per_frame"]["tracking"]
    assert out["value"] == round(fps, 2) > 0
    assert abs(out["vs_baseline"] - fps / 33.0) <= 0.0005 + 1e-12
    assert out["full_slam_fps"] > 0 and out["keyframes_inserted"] == 0
    assert out["full_slam_inertial_fps"] is None and out["inertial_keyframes_inserted"] == 0
    assert out["inertial_error"] == "AssertionError: inertial bench failed to track"
    assert out["device"] == "cpu"
    assert out["ms_per_frame"]["tracking"] > 0 and out["ms_per_frame"]["full_slam_inertial"] is None
    assert out["host_reads_per_frame"] == {"tracking": None, "full_slam": None,
                                           "full_slam_inertial": None}
    assert set(orb_patches.launch_counts().values()) == {0}      # CPU: the twins


@pytest.mark.parametrize("fps, value, vs", [(0.675, 0.68, 0.02), (15.09, 15.09, 0.457)])
def test_report_rounds_vs_baseline_from_the_unrounded_fps(fps, value, vs):
    """bench.py:471-473 rounds fps and fps / 33 each from the unrounded fps.
    At 0.675 fps the value is 0.68 and vs_baseline 0.02, where rounding the
    rounded value (0.68 / 33) would give 0.021."""
    out = bench.report("cpu", _fake(fps), _fake(fps, 6),
                       _fake(fps, 6, warmup_frames=80, imu_init_frame=78), None)
    for k, ratio in (("value", "vs_baseline"), ("full_slam_fps", "full_slam_vs_baseline"),
                     ("full_slam_inertial_fps", "full_slam_inertial_vs_baseline")):
        assert (out[k], out[ratio]) == (value, vs), k
        assert out[ratio] == round(fps / 33.0, 3)


def test_main_exits_0_with_every_chain_and_1_when_one_raises(monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench_tracking_chain", lambda dev: _fake(5.0))
    monkeypatch.setattr(bench, "bench_full_system", lambda dev: _fake(4.0, 6))
    monkeypatch.setattr(bench, "bench_full_inertial",
                        lambda dev: _fake(0.5, 6, warmup_frames=107, imu_init_frame=106))
    assert bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "inertial_error" not in out and out["keyframes_inserted"] == 6
    assert out["full_slam_inertial_fps"] == 0.5 and out["inertial_keyframes_inserted"] == 6
    assert out["inertial_warmup_frames"] == 107 and out["imu_init_frame"] == 106
    assert out["ms_per_frame"] == {"tracking": 200.0, "full_slam": 250.0,
                                   "full_slam_inertial": 2000.0}

    def boom(dev):
        raise RuntimeError("chain failed")

    monkeypatch.setattr(bench, "bench_full_system", boom)
    assert bench.main(["--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"metric": "mono_tracking_frames_per_second", "value": None, "unit": "fps",
                   "vs_baseline": None, "error": "bench_exception",
                   "detail": "RuntimeError: chain failed"}


def test_bench_refuses_the_card_without_one(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        bench.main([])
    assert "pass --device cpu" in capsys.readouterr().err


# ------------------------------------------------- bench.py's depth: slow
@pytest.mark.slow
@pytest.mark.parametrize("chain", ["tracking", "full"])
def test_visual_chains_at_bench_py_depth_on_the_cpu(chain):
    """Both packages' chains at bench.py's depth: both run, the port's
    tracking chain passes `tracking_faults`, its full chain inserts
    bench.py's 6 keyframes and tracks within phase 6's ATE gate."""
    J = _jax_bench()
    if chain == "tracking":
        assert J.bench_tracking_chain(jax, jnp) > 0
        res = bench.bench_tracking_chain("cpu")
        assert len(res.frames) == 50 and bench.tracking_faults(res) == []
    else:
        fps, n_kf = J.bench_full_system(jax, jnp)
        res = bench.bench_full_system("cpu")
        assert fps > 0 and n_kf == res.keyframes == 6
        rmse, _, span = res.info["ate"]
        assert rmse < 0.08 * span


@pytest.mark.slow
def test_inertial_chain_at_bench_py_depth_on_the_cpu():
    """Both packages' inertial chains at bench.py's depth: JAX's passes its
    assert after 80 warm-up frames on its own scene, the mesas included;
    the port's IMU initializes within them too, so its warm-up ends at
    bench.py's 80 frames; both insert 6 keyframes, the port's within phase
    6's ATE gate."""
    fps, n_kf = _jax_bench().bench_full_inertial(jax, jnp)
    res = bench.bench_full_inertial("cpu")
    assert fps > 0 and n_kf == res.keyframes == 6
    assert res.info["warmup_frames"] == 80 and res.info["imu_init_frame"] < 80
    rmse, _, span = res.info["ate"]
    assert rmse < 0.08 * span
