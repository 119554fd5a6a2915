"""The port's stereo front end and `StereoSystem` against the JAX package's.

Per module: `stereo_match` on tests/test_stereo.py's world, `refine_disparity`
on the fractional-shift pair and on integer images whose SSDs tie (T2: the
first minimum wins in both, and the half-to-even rounding of the keypoint
and right-u pixels), `fisheye_stereo_match` against JAX and under the three
non-slow oracles of tests/test_fisheye_direct_stereo.py, with the forward
hemisphere gate.  Per System step, from one state: `_stereo_initialize`,
`_stereo_new_points` with room and at a nearly full map (T7), and an async
keyframe (`async_mapping`) whose depth points are appended after the
snapshot its pending chain optimizes, merged and held to JAX's merged map.
TestStereoMerge's right-u rows across a map merge.  The feature drive of
TestStereoPipeline and phase 11a of `chip_smoke.py` (the JAX and the port's
StereoSystem on bench.py's path rendered as rectified pairs, which gives
that phase its bounds) are marked slow.  Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.features import stereo as jst
from orbslam3_tpu.features.extractor import FeatureFrame as JFeatureFrame
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import map_merging as jmerge
from orbslam3_tpu.pipeline import stereo_system as jss
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.place import keyframe_db as jkdb
from orbslam3_tpu.slam_map import atlas as jatlas
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.features import stereo as tst
from orbslam3_tpu_torch.pipeline import map_merging as tmerge
from orbslam3_tpu_torch.pipeline import stereo_system as tss
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.utils import align as talign
from orbslam3_tpu_torch.utils import seeded_scene as scene
from orbslam3_tpu_torch.utils import sensor_scene as ss
import test_fisheye_direct_stereo as fds
from test_pipeline_e2e import HW, K4, N_KP, camera_path
from test_stereo import BASELINE, StereoWorld
from test_torch_loop import _jax_draw
from test_torch_merge import _fields_close

torch.set_num_threads(2)

FX = K4[0]


def _t(*arrays):
    out = [torch.from_numpy(np.array(a)) for a in arrays]
    return out[0] if len(out) == 1 else out


def _tff(jff):
    return convert.frame_from_numpy(H.fields(jff))


def _depth_close(got, ref, tol=1e-5):
    """valid equal; ur within `tol` px, depth within `tol` relative."""
    ok = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    np.testing.assert_allclose(got.ur.numpy(), np.asarray(ref.ur), atol=tol, rtol=0)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), rtol=tol, atol=0)


# ---------------------------------------------------------------------- modules
@pytest.mark.parametrize("seed", [11, 12])
def test_stereo_match_matches_jax(seed):
    """The row band, disparity range and octave gates, then the Hamming
    match: the same matches, ur within 1e-5 px, depth within 1e-5 relative;
    and tests/test_stereo.py's gate (70% matched, median depth error < 5%)."""
    w = StereoWorld(seed=seed)
    fl, fr, idx = w.stereo_frame(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                 noise_px=0.2)
    ref = jst.stereo_match(fl, fr, FX, BASELINE)
    got = tst.stereo_match(_tff(fl), _tff(fr), FX, BASELINE)
    _depth_close(got, ref)
    ok = got.valid.numpy()[:len(idx)]
    assert ok.mean() > 0.7
    z_true = w.X[idx][:, 2]
    rel = np.abs(got.depth.numpy()[:len(idx)][ok] - z_true[ok]) / z_true[ok]
    assert np.median(rel) < 0.05


def _shifted_pair(seed=3, h=64, w=128, true_disp=4.6):
    """TestSubpixelRefinement's pair: a smoothed random image and its
    fractional shift."""
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, (h, w + 8)).astype(np.float64)
    for _ in range(2):
        big = 0.25 * (np.roll(big, 1, 1) + np.roll(big, -1, 1) + np.roll(big, 1, 0)
                      + np.roll(big, -1, 0))
    xs = np.arange(w) + true_disp
    x0 = xs.astype(int)
    f = xs - x0
    img_l = big[:, :w].astype(np.float32)
    img_r = ((1 - f) * big[:, x0] + f * big[:, x0 + 1]).astype(np.float32)
    n = 12
    xy = np.stack([rng.uniform(20, w - 20, n), rng.uniform(10, h - 10, n)], 1).astype(np.float32)
    return img_l, img_r, xy


def _refine_both(img_l, img_r, xy, ur0, valid=None):
    n = len(xy)
    valid = np.ones(n, bool) if valid is None else valid
    dj = jst.StereoDepth(ur=jnp.asarray(ur0, jnp.float32), depth=jnp.ones(n),
                         valid=jnp.asarray(valid))
    ref = jst.refine_disparity(jnp.asarray(img_l), jnp.asarray(img_r), jnp.asarray(xy), dj,
                               fx=100.0, baseline=0.1)
    dt = tst.StereoDepth(*_t(np.asarray(ur0, np.float32), np.ones(n, np.float32), valid))
    got = tst.refine_disparity(*_t(img_l, img_r, xy), dt, fx=100.0, baseline=0.1)
    return got, ref


def test_refine_disparity_matches_jax():
    """The SSD sweep and parabola on the fractional shift: ur within 1e-4 px
    of JAX's (float SSDs summed in another order), depth within 1e-5
    relative, and the JAX test's gate (median disparity error < 0.25 px)."""
    img_l, img_r, xy = _shifted_pair()
    ur0 = np.round(xy[:, 0]) - 5.0
    got, ref = _refine_both(img_l, img_r, xy, ur0)
    np.testing.assert_allclose(got.ur.numpy(), np.asarray(ref.ur), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), rtol=1e-5)
    assert np.median(np.abs(np.round(xy[:, 0]) - got.ur.numpy() - 4.6)) < 0.25


def test_refine_disparity_ties_and_rounding_match_jax():
    """T2 and the rounding: integer images whose columns repeat with period
    2, so the SSDs of shifts k and k + 2 are exactly equal (integer SSDs are
    exact in float32: 11 * 11 * 255^2 < 2^24) and argmin must take the first
    in both; keypoints and right-u at exact halves (x.5 rounds to the even
    integer in `jnp.round` and `torch.round`).  Every output bit-equal."""
    rng = np.random.default_rng(5)
    h, w = 48, 96
    cols = rng.integers(0, 256, (h, 2)).astype(np.float32)
    img_l = np.tile(cols, (1, w // 2))
    img_r = np.roll(img_l, -3, axis=1)
    img_r[:, ::7] = rng.integers(0, 256, (h, len(range(0, w, 7))))    # break some ties
    xy = np.stack([np.arange(30.5, 62.5, 2.0), np.full(16, 20.5)], 1).astype(np.float32)
    ur0 = (xy[:, 0] - 3.5).astype(np.float32)          # right-u at halves as well
    valid = np.ones(16, bool)
    valid[3] = False
    got, ref = _refine_both(img_l, img_r, xy, ur0, valid)
    np.testing.assert_array_equal(got.ur.numpy(), np.asarray(ref.ur))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    # the ties are real: the minimum of the five SSDs repeats for some
    # keypoints (recomputed here in int64 from the same windows)
    x0 = np.clip(np.round(xy[:, 0]).astype(int) - 5, 0, w - 11)
    y0 = np.clip(np.round(xy[:, 1]).astype(int) - 5, 0, h - 11)
    r0 = np.clip(np.round(ur0).astype(int) - 7, 0, w - 15)
    L, R = img_l.astype(np.int64), img_r.astype(np.int64)
    ssd = np.array([[np.sum((R[y:y + 11, r + k:r + k + 11] - L[y:y + 11, x:x + 11]) ** 2)
                     for k in range(5)] for x, y, r in zip(x0, y0, r0)])
    tied = (ssd == ssd.min(axis=1, keepdims=True)).sum(axis=1) > 1
    assert tied[valid].sum() >= 3
    assert ssd.max() < 2 ** 24
    np.testing.assert_array_equal(torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])).numpy(),
                                  np.asarray(jnp.round(jnp.asarray([0.5, 1.5, 2.5, -0.5]))))


_FDS = fds.TestFisheyeDirectStereo()


def _fisheye_both(R_bad=None, t_bad=None, theta_max=1.15, seed=0, band=None):
    """`fisheye_stereo_match` in both packages on test_fisheye_direct_stereo's
    rig; `band` = (theta_lo, theta_hi): the points instead at polar angles in
    that band toward the image corners, where the 512x512 image reaches
    furthest off the axis."""
    c0, c1, R, t, X, th, rng = _FDS._rig_points(seed=seed, theta_max=theta_max)
    if band is not None:
        th = rng.uniform(*band, len(X))
        ph = np.pi / 4 + np.pi / 2 * rng.integers(0, 4, len(X)) + rng.uniform(-0.3, 0.3, len(X))
        d = rng.uniform(1.0, 3.2, len(X))
        X = np.stack([np.sin(th) * np.cos(ph) * d, np.sin(th) * np.sin(ph) * d,
                      np.cos(th) * d], 1).astype(np.float32)
    ff_l, ff_r, p0, p1, keep = _FDS._frames(c0, c1, R, t, X, rng)
    R_use = R if R_bad is None else R_bad
    t_use = t if t_bad is None else t_bad
    ref = jst.fisheye_stereo_match(ff_l, ff_r, p0, p1, jnp.asarray(R_use), jnp.asarray(t_use))
    got = tst.fisheye_stereo_match(_tff(ff_l), _tff(ff_r), *_t(np.asarray(p0), np.asarray(p1),
                                                               R_use, t_use))
    return got, ref, X, th, keep


def _fisheye_close(got, ref, tol=1e-4):
    """The same matches, X within `tol` of its distance, X finite."""
    ok = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    np.testing.assert_array_equal(got.ridx.numpy(), np.asarray(ref.ridx))
    Xr = np.asarray(ref.X)
    scale = np.maximum(np.linalg.norm(Xr, axis=1), 1.0)
    assert (np.linalg.norm(got.X.numpy() - Xr, axis=1) <= tol * scale).all()
    assert np.isfinite(got.X.numpy()).all()


def test_fisheye_stereo_recovers_metric_geometry():
    """Against JAX (`_fisheye_close`) and test_recovers_metric_geometry's
    gates: 70% matched, median error < 0.08 and < 3% of the distance."""
    got, ref, X, th, keep = _fisheye_both()
    _fisheye_close(got, ref)
    ok = got.valid.numpy()
    n_in = int(keep.sum())
    assert ok[:n_in].sum() > 0.7 * n_in
    err = np.linalg.norm(got.X.numpy()[:n_in][ok[:n_in]] - X[keep][ok[:n_in]], axis=1)
    assert np.median(err) < 0.08
    assert np.median(err / np.linalg.norm(X[keep][ok[:n_in]], axis=1)) < 0.03


def test_fisheye_stereo_keeps_the_periphery():
    """test_keeps_periphery_the_rectified_path_crops' gate on the port:
    beyond the rectified preset's half field of view (`config.tumvi_stereo_
    inertial`, the port's copy) more than 60% of the periphery is
    triangulated."""
    from orbslam3_tpu_torch import config as presets
    got, ref, X, th, keep = _fisheye_both()
    _fisheye_close(got, ref)
    cfg = presets.tumvi_stereo_inertial()[0]
    fx, fy, cx, cy = cfg.cam_params
    w = cfg.image_hw[1]
    half_fov = float(np.arctan(max((w - cx) / fx, cx / fx)))
    n_in = int(keep.sum())
    periph = th[keep] > half_fov + 0.05
    assert periph.sum() > 20
    assert (got.valid.numpy()[:n_in] & periph).sum() > 0.6 * periph.sum()


def test_fisheye_stereo_rejects_a_wrong_rig():
    """test_rejects_wrong_rig: a wrong baseline kills the epipolar gate
    (fewer than 10% matched), as in JAX."""
    got, ref, X, th, keep = _fisheye_both(t_bad=np.array([0.0, 0.3, 0.0], np.float32))
    _fisheye_close(got, ref)
    assert int(got.valid.sum()) < 0.1 * int(keep.sum())


def test_fisheye_stereo_forward_hemisphere_gate():
    """Points 75 to 100 degrees off the axis: no bearing with z <= 0.05
    (beyond ~87 degrees) is matched, and X is finite everywhere (the mask
    acts before the DLT's division by the ray's z); as JAX, with X within
    5e-4 of its distance (a bearing close to the gate, z ~ 0.05, is
    ill-conditioned in the z-normalized DLT: one float32 ulp of it moves X
    by ~1e-4 of its distance)."""
    got, ref, X, th, keep = _fisheye_both(seed=1, band=(1.3, 1.75))
    _fisheye_close(got, ref, tol=5e-4)
    n_in = int(keep.sum())
    beyond = th[keep] > np.arccos(0.05)
    assert beyond.sum() > 5
    assert not got.valid.numpy()[:n_in][beyond].any()


# --------------------------------------------------------------- System steps
def _systems(cap=None, **overrides):
    """A JAX and a port StereoSystem with test_stereo's configuration."""
    base = dict(cam_params=K4, image_hw=HW, max_frames_between_kf=8, ba_caps=(24, 4096, 16384),
                stereo_bf=FX * BASELINE, enable_relocalization=False, **overrides)
    jcap = None if cap is None else jstate.MapCapacity(**cap)
    tcap = None if cap is None else MapCapacity(**cap)
    jcfg = jsystem.SlamConfig(**base, **({} if cap is None else dict(map_capacity=jcap)))
    tcfg = tsystem.SlamConfig(**base, **({} if cap is None else dict(map_capacity=tcap)))
    return (jss.StereoSystem(jcfg, jss.StereoConfig(baseline=BASELINE)),
            tss.StereoSystem(tcfg, tss.StereoConfig(baseline=BASELINE), device="cpu"))


def _map_equal(got, ref, tol_R=1e-5, tol_X=1e-5, skip=()):
    """Integer fields equal, poses within tol_R, points within tol_X of
    their distance from the origin (at least 1)."""
    g, r = convert.to_numpy(got), H.fields(ref)
    floats = ("kf_R", "kf_t", "pt_xyz", "kf_vel", "loop_t", "pt_normal", "pt_min_dist",
              "pt_max_dist", "obs_uv", "obs_ur", "kf_ts", "kf_bias", "loop_R", "loop_s")
    _fields_close(g, r, atol=1e-5, skip=floats + tuple(skip))
    np.testing.assert_allclose(g["kf_R"], r["kf_R"], atol=tol_R, rtol=0)
    np.testing.assert_allclose(g["kf_t"], r["kf_t"], atol=tol_R, rtol=0)
    scale = np.maximum(np.linalg.norm(r["pt_xyz"], axis=1), 1.0)
    assert (np.linalg.norm(g["pt_xyz"] - r["pt_xyz"], axis=1) <= tol_X * scale).all()
    for name in ("obs_uv", "obs_ur", "pt_min_dist", "pt_max_dist", "pt_normal"):
        np.testing.assert_allclose(g[name], r[name], rtol=1e-5, atol=1e-4, err_msg=name)


def _init_inputs(seed=12):
    w = StereoWorld(seed=seed)
    R, t, _ = camera_path(1)[0]
    fl, fr, _ = w.stereo_frame(R, t, noise_px=0.2)
    return w, fl, fr


def test_stereo_initialize_matches_jax():
    """One stereo pair's map (Tracking::StereoInitialization) from the same
    keypoints and depths: every integer field of the map and the bank equal
    (the same points from the same keypoints, in the same slots), positions
    within 1e-5 relative, and keyframe 0 at the origin.  The port reads the
    depth count once, as JAX does."""
    _, fl, fr = _init_inputs()
    jsys, tsys = _systems()
    jsys._depth = jst.stereo_match(fl, fr, FX, BASELINE, max_depth=35.0 * BASELINE * 3)
    tsys._depth = convert.stereo_depth_from_numpy(H.fields(jsys._depth))
    jsys.frame_id = tsys.frame_id = 0
    jsys._stereo_initialize(fl, 0.0)
    tsys._stereo_initialize(_tff(fl), 0.0)
    assert jsys.state == tsys.state == tsystem.OK
    assert tsys.n_kf_host == jsys.n_kf_host == 1 and tsys.last_kf_idx == jsys.last_kf_idx == 0
    assert tsys.inliers_at_last_kf == jsys.inliers_at_last_kf > 100
    _map_equal(tsys.map, jsys.map)
    _fields_close(convert.to_numpy(tsys.bank), H.fields(jsys.bank), atol=1e-5)


def test_stereo_checkpoint_carries_ur_rows(tmp_path):
    """A stereo session saved by the port (`checkpoint.save_system`) keeps
    each keyframe's right-u row (`ur_<k>`, JAX's kf_ur): restored by the
    port into the bank and by JAX into its kf_ur, equal to the saved rows."""
    from orbslam3_tpu.slam_map import checkpoint as jck
    from orbslam3_tpu_torch.slam_map import checkpoint as tck
    _, fl, fr = _init_inputs()
    jsys, tsys = _systems()
    tsys._depth = tst.stereo_match(_tff(fl), _tff(fr), FX, BASELINE, max_depth=35.0 * BASELINE * 3)
    tsys.frame_id = 0
    tsys._stereo_initialize(_tff(fl), 0.0)
    ur = tsys.bank.ur[0].numpy()
    assert (ur > 0).sum() > 100
    path = str(tmp_path / "stereo.npz")
    tck.save_system(path, tsys)
    back = _systems()[1]
    tck.load_system(path, back)
    np.testing.assert_array_equal(back.bank.ur.numpy(), tsys.bank.ur.numpy())
    jck.load_system(path, jsys)
    np.testing.assert_array_equal(np.asarray(jsys.kf_ur[0]), ur)
    np.testing.assert_array_equal(np.asarray(jsys.bank.ur[0]), ur)


@pytest.mark.parametrize("room", [None, 20], ids=["room", "nearly-full"])
def test_stereo_new_points_matches_jax(room):
    """CreateNewKeyFrame's depth points for keyframe 1's unbound keypoints,
    from one state (keyframe 0 from the first pair, keyframe 1 a later pose
    with every third keypoint bound).  With room: every free keypoint with a
    depth becomes a point.  Nearly full (T7, `room` slots left): add_points
    drops the overflow and the bindings name only the points written.  The
    map, bank and bindings as JAX's: integer fields equal, positions within
    1e-5 relative."""
    w, fl, fr = _init_inputs()
    d0 = jst.stereo_match(fl, fr, FX, BASELINE, max_depth=35.0 * BASELINE * 3)
    n0 = int(np.sum(np.asarray(d0.valid) & np.asarray(fl.valid)))
    cap = None if room is None else dict(n_kf=16, n_pt=n0 + room, n_obs=8192)
    jsys, tsys = _systems(cap=cap, **({} if cap is None else dict(local_view_points=256)))
    jsys._depth = d0
    jsys.frame_id = 0
    jsys._stereo_initialize(fl, 0.0)
    R, t, _ = camera_path(6)[5]
    fl1, fr1, _ = w.stereo_frame(R, t, noise_px=0.2)
    jsys._depth = jst.stereo_match(fl1, fr1, FX, BASELINE, max_depth=35.0 * BASELINE * 3)
    m, k1 = jstate.add_keyframe(jsys.map, jnp.asarray(R), jnp.asarray(t), 0.25, 5)
    bind = np.where(np.arange(N_KP) % 3 == 0, np.arange(N_KP) % max(n0, 1), -1).astype(np.int32)
    bind[~np.asarray(fl1.valid)] = -1
    jsys.map, jsys.frame_id, jsys.last_kf_idx, jsys.n_kf_host = m, 5, 1, 2
    jsys.kf_bindings[1] = jnp.asarray(bind)
    jsys.kf_features[1] = fl1
    jsys._bank_store(1, fl1, jnp.asarray(bind))
    H.copy_system_state(jsys, tsys)
    jsys._stereo_new_points(fl1)
    tsys._stereo_new_points(_tff(fl1))
    _map_equal(tsys.map, jsys.map)
    kp = tsys.bank.kp_pt[1].numpy()
    np.testing.assert_array_equal(kp, np.asarray(jsys.kf_bindings[1]))
    np.testing.assert_array_equal(tsys.bank.kp_pt.numpy(), np.asarray(jsys.bank.kp_pt))
    n_pt, cap_pt = int(tsys.map.n_pt), tsys.map.pt_xyz.shape[0]
    assert (kp < n_pt).all()
    free = (bind < 0) & np.asarray(fl1.valid) & np.asarray(jsys._depth.valid)
    if room is None:
        assert (kp[free] >= 0).all() and n_pt == n0 + free.sum()
    else:
        assert n_pt == cap_pt == n0 + room and (kp[free] >= 0).sum() == room
        assert (kp[free] < 0).sum() == free.sum() - room


def test_async_stereo_keyframe_matches_jax_merged_map():
    """`async_mapping`: the keyframe inserts and triangulates, posts culling
    and the window BA against the post-insert snapshot, and then the depth
    points are appended to the live map, after that snapshot; the forced
    merge (`merge_opt`) keeps them, moved by the anchor correction, and runs
    the stages after the BA.  From the JAX System's state at its second
    keyframe (the same frame, tracking result and depth), the port's merged
    map as JAX's: integer fields equal (the depth points among them),
    keyframe poses within 1e-4, points within 1e-3 of their distance (the
    float32 window BA)."""
    w = StereoWorld(seed=12)
    poses = camera_path(20, speed=0.06)
    jsys, tsys = _systems(async_mapping=True)
    seen = []
    insert = jsys._insert_keyframe

    def spy(ff, tr, ts, n_inl=None):
        if jsys.n_kf_host == 2 and not seen:
            jsys._merge_pending(force=True)
            H.copy_system_state(jsys, tsys)
            seen.append((ff, tr, ts, n_inl, int(jsys.map.n_pt)))
        return insert(ff, tr, ts, n_inl=n_inl)

    jsys._insert_keyframe = spy
    for i, (R, t, _) in enumerate(poses):
        fl, fr, _ = w.stereo_frame(R, t, noise_px=0.2)
        jsys.track_stereo(None, None, i * 0.05, features_l=fl, features_r=fr)
        if seen:
            break
    assert seen, "no second keyframe"
    ff, tr, ts, n_inl, n_before = seen[0]
    jsys._merge_pending(force=True)
    trt = type("Tr", (), dict(kp_pt=_t(np.asarray(tr.kp_pt)), R=_t(np.asarray(tr.R)),
                              t=_t(np.asarray(tr.t))))
    tsys._insert_keyframe(_tff(ff), trt, ts, n_inl)
    assert tsys.chain_counts["posted kf"] == 1 and tsys._pending is not None
    # the depth points are in the live map, past the snapshot the chain holds
    assert int(tsys.map.n_pt) > int(tsys._pending.m_opt.n_pt) >= n_before
    tsys._drain_pending()
    assert tsys._pending is None
    _map_equal(tsys.map, jsys.map, tol_R=1e-4, tol_X=1e-3)
    np.testing.assert_array_equal(tsys.bank.kp_pt.numpy(), np.asarray(jsys.bank.kp_pt))
    np.testing.assert_array_equal(tsys.bank.ur.numpy() >= 0, np.asarray(jsys.bank.ur) >= 0)


def test_stereo_merge_keeps_ur_rows_as_jax():
    """TestStereoMerge's scene (an archived stereo session and the current
    stereo map at a rigid offset, every observation with its right-u) in
    both packages, the port drawing JAX's Sim3 samples (`PRNGKey(1000 +
    kf_idx)`): both merge with the same offsets, the spliced bank's ur rows
    equal JAX's rebuild from its kf_ur dictionaries on both sides of the
    weld, the welded map's integer fields equal and poses within 1e-4; then
    the port's post-merge window BA holds the metric scale (|s - 1| < 0.02,
    the JAX test's gate)."""
    rng = np.random.default_rng(5)
    n_pts, n_kp, bf = 200, 256, FX * BASELINE
    cap = dict(n_kf=32, n_pt=4096, n_obs=16384)
    X0 = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                   rng.uniform(4, 9, n_pts)], 1).astype(np.float32)
    desc0 = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    uv0 = np.asarray(jcam.pinhole_project(jnp.asarray(K4), jnp.asarray(X0)))
    ur0 = (uv0[:, 0] - bf / X0[:, 2]).astype(np.float32)

    def pad(a, fill, n=None):
        n = len(a) if n is None else n
        out = np.full((n_kp,) + a.shape[1:], fill, a.dtype)
        out[:n] = a[:n]
        return out

    def ff(n):
        return dict(xy=pad(uv0, 0.0, n), response=np.ones(n_kp, np.float32),
                    octave=np.zeros(n_kp, np.int32), angle=np.zeros(n_kp, np.float32),
                    desc=pad(desc0, 0, n), valid=np.arange(n_kp) < n)

    jff = lambda f: JFeatureFrame(**{k: jnp.asarray(v) for k, v in f.items()})
    base = dict(cam_params=K4, image_hw=(480, 752), enable_loop_closing=True, stereo_bf=bf)
    jsys = jsystem.System(jsystem.SlamConfig(**base, map_capacity=jstate.MapCapacity(**cap)))
    tsys = tsystem.System(tsystem.SlamConfig(**base, map_capacity=MapCapacity(**cap)),
                          device="cpu")
    m_old = jstate.empty_map(jsys.cfg.map_capacity)
    m_old, k0 = jstate.add_keyframe(m_old, jnp.eye(3), jnp.zeros(3), 0.0, 0)
    m_old, pt0 = jstate.add_points(m_old, jnp.asarray(X0), jnp.asarray(desc0),
                                   jnp.tile(jnp.array([0.0, 0, 1]), (n_pts, 1)),
                                   jnp.full(n_pts, 1.0), jnp.full(n_pts, 30.0), 0, 0,
                                   jnp.ones(n_pts, bool))
    m_old = jstate.add_observations(m_old, k0, pt0, jnp.asarray(uv0), jnp.zeros(n_pts, jnp.int32),
                                    jnp.ones(n_pts, bool), ur=jnp.asarray(ur0))
    bow, _ = jsys.loop_closer._bow(jff(ff(n_pts)).desc, jff(ff(n_pts)).valid)
    old_db = jkdb.add(jkdb.KeyframeDB.create(cap["n_kf"], jsys.loop_closer.cfg.n_words), 0, bow)
    jsys.atlas.sessions.append(jatlas.MapSession(
        map=m_old, kf_features={0: jff(ff(n_pts))},
        kf_bindings={0: jnp.asarray(pad(np.asarray(pt0), -1))},
        trajectory=[(0.0, np.eye(3), np.zeros(3))], db=old_db,
        kf_ur={0: jnp.asarray(pad(ur0, -1.0))}))
    Rz = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.0, 0.25])))
    dtv = np.array([1.0, -0.5, 0.3], np.float32)
    R_cur = jnp.asarray(Rz.T, jnp.float32)
    t_cur = jnp.asarray(-Rz.T @ dtv, jnp.float32)
    X_cur = (X0 @ Rz.T + dtv).astype(np.float32)
    m = jsys.map
    m, kA = jstate.add_keyframe(m, R_cur, t_cur, 10.0, 100)
    m, kB = jstate.add_keyframe(m, R_cur, t_cur, 10.5, 101)
    m, ptc = jstate.add_points(m, jnp.asarray(X_cur), jnp.asarray(desc0),
                               jnp.tile(jnp.array([0.0, 0, 1]), (n_pts, 1)),
                               jnp.full(n_pts, 1.0), jnp.full(n_pts, 30.0), int(kB), 101,
                               jnp.ones(n_pts, bool))
    m = jstate.add_observations(m, kB, ptc, jnp.asarray(uv0), jnp.zeros(n_pts, jnp.int32),
                                jnp.ones(n_pts, bool), ur=jnp.asarray(ur0))
    ptc = np.asarray(ptc)
    feats = {0: ff(50), 1: ff(n_pts)}
    binds = {0: pad(ptc, -1, 50), 1: pad(ptc, -1)}
    urs = {0: pad(ur0, -1.0, 50), 1: pad(ur0, -1.0)}
    jsys.map = m
    jsys.kf_features = {k: jff(f) for k, f in feats.items()}
    jsys.kf_bindings = {k: jnp.asarray(b) for k, b in binds.items()}
    jsys.kf_ur = {k: jnp.asarray(u) for k, u in urs.items()}
    jsys.R_cur, jsys.t_cur = R_cur, t_cur
    jsys.last_kf_idx, jsys.n_kf_host = 1, 2
    jsys._ensure_bank(jff(feats[1]))
    H.copy_system_state(jsys, tsys)
    tsys.bank = convert.bank_from_frames(cap["n_kf"], feats, binds, ur=urs)
    assert (tsys.atlas.sessions[0].bank.ur[0].numpy() > 0).sum() == n_pts
    assert jmerge.try_merge(jsys, jff(feats[1]), 1)
    assert tmerge.try_merge(
        tsys, convert.frame_from_numpy(feats[1]), 1,
        idx_fn=lambda kf, valid: _jax_draw(jax.random.PRNGKey(1000 + kf), valid))
    lm = tsys.last_merge
    assert (lm["kf_off"], lm["pt_off"]) == (1, n_pts)
    np.testing.assert_array_equal(tsys.bank.ur.numpy(), np.asarray(jsys.bank.ur))
    assert (tsys.bank.ur[0].numpy() > 0).sum() >= 0.9 * n_pts
    assert (tsys.bank.ur[2].numpy() > 0).sum() >= 0.9 * n_pts
    _map_equal(tsys.map, jsys.map, tol_R=1e-4, tol_X=1e-4)
    # the post-merge window BA (bank-sourced, stereo rows) holds the scale
    m3 = tsys.map._replace(loop_valid=torch.zeros_like(tsys.map.loop_valid))
    m3 = tsystem.local_ba(tsys.cfg, tsys.cam_params, m3, tsys.last_kf_idx, tsys.bank)
    new = ptc + n_pts
    d = lambda xyz: np.linalg.norm(xyz[new][:20] - xyz[new][20:40], axis=1)
    s = np.median(d(m3.pt_xyz.numpy()) / np.maximum(d(tsys.map.pt_xyz.numpy()), 1e-9))
    assert abs(s - 1.0) < 0.02, s


# ------------------------------------------------------------------- drives
@pytest.mark.slow
class TestStereoPipeline:
    def test_metric_trajectory_without_scale_alignment(self):
        """tests/test_stereo.py's 50-frame feature drive on the port's
        StereoSystem, with its gates: no reset, OK, rigid ATE < 0.02, the
        Umeyama scale within 0.01 of 1."""
        w = StereoWorld(seed=12)
        poses = camera_path(50, speed=0.06)
        cfg = tsystem.SlamConfig(cam_params=K4, image_hw=HW, max_frames_between_kf=8,
                                 ba_caps=(24, 4096, 16384), stereo_bf=FX * BASELINE)
        sys_ = tss.StereoSystem(cfg, tss.StereoConfig(baseline=BASELINE), device="cpu")
        for i, (R_cw, t_cw, _) in enumerate(poses):
            fl, fr, _ = w.stereo_frame(R_cw, t_cw, noise_px=0.2)
            sys_.track_stereo(None, None, ts=i * 0.05, features_l=_tff(fl), features_r=_tff(fr))
        assert sys_.n_resets == 0 and sys_.state == tsystem.OK
        est = np.stack([p[2] for p in sys_.trajectory])
        gt = np.stack([poses[int(round(t / 0.05))][2] for t, _, _ in sys_.trajectory])
        assert talign.ate_rmse(est, gt, with_scale=False)[0] < 0.02
        assert abs(talign.ate_rmse(est, gt)[1] - 1.0) < 0.01


@pytest.mark.slow
def test_phase_11a_stereo_on_bench_path():
    """Phase 11a's drive on the CPU at full size (480x752, 1200 features,
    the default capacity): bench.py's 78 frames as rectified pairs through
    the JAX and the port's `track_stereo`.  Both hold the phase's gates
    (`sensor_scene.check_depth_gates` with its STEREO_MAX_ATE
    and STEREO_MAX_SCALE_ERR), the same first-pair map size, and the port's
    rigid ATE and scale within 1e-3 of JAX's."""
    cfg = dataclasses.replace(scene.SceneConfig(), seed_frames=(), track_frames=tuple(range(78)))
    slam, st = ss.stereo_configs(cfg)
    left, right = scene.render_frames(cfg), ss.render_right_frames(cfg)
    out = {}
    for name, sys_ in (("jax", jss.StereoSystem(H.jax_config(slam), H.jax_config(st))),
                       ("port", tss.StereoSystem(slam, st, device="cpu"))):
        d = ss.drive(sys_, cfg.track_frames, ss.stereo_step(left, right))
        bad, out[name] = ss.check_depth_gates(sys_, d, ss.STEREO_MAX_ATE, ss.STEREO_MAX_SCALE_ERR)
        print(name, out[name])
        assert bad == [], (name, bad)
    assert out["port"]["n_init_points"] == out["jax"]["n_init_points"]
    assert abs(out["port"]["ate"] - out["jax"]["ate"]) < 1e-3
    assert abs(out["port"]["scale"] - out["jax"]["scale"]) < 1e-3
