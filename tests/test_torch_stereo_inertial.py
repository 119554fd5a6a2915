"""The port's stereo-inertial System, the dataset presets and the stereo
rectification against the JAX package's.

The fixed-scale inertial initialization of `StereoInertialSystem` from one
state (keyframes along tests/test_fisheye_direct_stereo.py's path, the
preintegrations of its accelerometer): the scale stays 1 and the map, the
gravity rotation, the bias and the velocities come out as JAX's.  The first
raw-fisheye pair: the map from the bearing-space matches and `last_body` set
at the initialization.  `io/rectify.stereo_rectify` (pinhole and KB8) and
`io/euroc.apply_undistort`; the nine presets of `config.py`, every field of
every returned config object against JAX's, and a System of the port built
from each.  The raw-fisheye stereo-inertial drive of
tests/test_fisheye_direct_stereo.py:137 (about 150 s in one process on the
port) and phase 11c of `chip_smoke.py` (the same drive with the TUM-VI
camera through the JAX and the port's Systems, which gives that phase its
numbers) are marked slow.  Each test states its tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu import config as jpresets
from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.io import euroc as jeuroc
from orbslam3_tpu.io import rectify as jrect
from orbslam3_tpu.pipeline import stereo_inertial_system as jsi
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch import config as tpresets
from orbslam3_tpu_torch.io import euroc as teuroc
from orbslam3_tpu_torch.io import rectify as trect
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import rgbd_system as trgbd
from orbslam3_tpu_torch.pipeline import stereo_inertial_system as tsi
from orbslam3_tpu_torch.pipeline import stereo_system as tss
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map import state as tstate
from orbslam3_tpu_torch.utils import sensor_scene as ss
from test_torch_merge import _fields_close

torch.set_num_threads(2)

SCENE = ss.FisheyeSIScene.test_camera()


def _si_systems(cap=None, **icfg_overrides):
    """A JAX and a port StereoInertialSystem with the raw-fisheye test's
    configuration (no keyframe database; `cap` a smaller map capacity)."""
    tc, tic, tsc = SCENE.configs()
    small = {} if cap is None else dict(local_view_points=512,
                                        map_capacity=tstate.MapCapacity(**cap))
    tc = dataclasses.replace(tc, enable_relocalization=False, **small)
    jc, jic, jsc = (H.jax_config(c) for c in (tc, tic, tsc))
    return (jsi.StereoInertialSystem(jc, dataclasses.replace(jic, **icfg_overrides), jsc),
            tsi.StereoInertialSystem(tc, dataclasses.replace(tic, **icfg_overrides), tsc,
                                     device="cpu"))


def test_fixed_scale_inertial_init_matches_jax():
    """`_initialize_imu` of the stereo-inertial System (imu_fix_scale: the
    reference's bFixedScale) on six keyframes 0.3 s apart along the scene's
    path with the factors of its accelerometer: both re-anchor the map into
    the gravity frame at scale 1 (every keyframe distance kept within 1e-5
    relative), the gravity direction of every keyframe's frame within 1e-4
    of JAX's, bias within 1e-5, velocities of the true magnitude within
    0.02.  The path does not rotate, so the yaw about gravity is free: the
    two solvers may settle on different ones (a few milliradians), and the
    poses and velocities are compared up to that yaw."""
    jsys, tsys = _si_systems(cap=dict(n_kf=16, n_pt=1024, n_obs=4096), fiba=False)
    times = [0.3 * k for k in range(6)]
    samples = [s for i in range(1, int(times[-1] * SCENE.fps) + 1) for s in SCENE.imu_samples(i)]
    for sys_, on, ms in ((jsys, jnp.asarray, jstate), (tsys, torch.tensor, tstate)):
        sys_.kf_imu_buffer = list(samples)
        m = sys_.map
        for k, t in enumerate(times):
            pos = SCENE.pos(t).astype(np.float32)
            R = on(np.eye(3, dtype=np.float32))
            m = ms.add_keyframe(m, R, on(-pos), t, 3 * k)[0]
            if k:
                pre, raw = sys_._preintegrate_buffer(times[k - 1], t)
                sys_.preints.append(pre)
                sys_.preint_kf_pairs.append((k - 1, k))
                sys_.preint_raw.append(raw)
        sys_.map = m
        sys_.last_kf_idx, sys_.n_kf_host, sys_.frame_id = 5, 6, 15
        sys_.kf_time0 = 0.0
    pos0 = np.stack([SCENE.pos(t) for t in times])
    assert jsys._initialize_imu(1e2, 1e6) and tsys._initialize_imu(1e2, 1e6)
    g, r = convert.to_numpy(tsys.map), H.fields(jsys.map)
    # world z (gravity) seen from each keyframe: R_cw[:, 2]
    np.testing.assert_allclose(g["kf_R"][:6, :, 2], r["kf_R"][:6, :, 2], atol=1e-4)
    # the two worlds differ by a yaw D about z: R_port = R_jax D
    D = r["kf_R"][0].T @ g["kf_R"][0]
    assert abs(D[2, 2] - 1.0) < 1e-6
    np.testing.assert_allclose(g["kf_R"][:6], r["kf_R"][:6] @ D, atol=1e-4)
    np.testing.assert_allclose(g["kf_vel"][:6], r["kf_vel"][:6] @ D, atol=1e-4)
    np.testing.assert_allclose(tsys.bias.numpy(), np.asarray(jsys.bias), atol=1e-5)
    C = np.einsum("kji,kj->ki", g["kf_R"][:6], -g["kf_t"][:6])       # centres
    d_new = np.linalg.norm(C[1:] - C[0], axis=1)
    d_old = np.linalg.norm(pos0[1:] - pos0[0], axis=1)
    np.testing.assert_allclose(d_new, d_old, rtol=1e-5)
    # the velocities are the path's, in the gravity frame: |v| kept
    v_true = np.stack([(SCENE.pos(t + 1e-4) - SCENE.pos(t - 1e-4)) / 2e-4 for t in times])
    np.testing.assert_allclose(np.linalg.norm(g["kf_vel"][:6], axis=1),
                               np.linalg.norm(v_true, axis=1), atol=0.02)
    assert tsys.imu_initialized and tsys.imu_fix_scale


def test_first_raw_fisheye_pair_matches_jax():
    """`track_stereo` on the scene's first pair (features extracted once, by
    JAX, and handed to both): the raw-fisheye depth (bearing-space epipolar
    matching, ray DLT) and the map made from it as JAX's (integer fields
    equal, floats within 1e-4, scale ranges within 1e-4 relative), OK at the
    origin, `last_body` set at the
    initialization, and no right-u rows (raw mode)."""
    jsys, tsys = _si_systems()
    img_l, img_r = _first_pair()
    fl = jx.extract_jit(jnp.asarray(img_l), jsys.cfg.orb)
    fr = jx.extract_jit(jnp.asarray(img_r), jsys.cfg.orb)
    sj, _ = jsys.track_stereo(None, None, 0.0, features_l=fl, features_r=fr)
    st, pose = tsys.track_stereo(None, None, 0.0, features_l=convert.frame_from_numpy(
        H.fields(fl)), features_r=convert.frame_from_numpy(H.fields(fr)))
    assert sj == st == tsystem.OK
    np.testing.assert_array_equal(tsys._depth.valid.numpy(), np.asarray(jsys._depth.valid))
    np.testing.assert_allclose(tsys._depth.depth.numpy(), np.asarray(jsys._depth.depth),
                               rtol=1e-4, atol=0)
    g, r = convert.to_numpy(tsys.map), H.fields(jsys.map)
    _fields_close(g, r, atol=1e-4, skip=("pt_min_dist", "pt_max_dist"))
    for name in ("pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(g[name], r[name], rtol=1e-4, err_msg=name)
    assert int(tsys.map.n_pt) > 100
    assert (tsys.bank.ur.numpy() == -1.0).all()
    Rwb, pwb = tsys.last_body
    np.testing.assert_allclose(Rwb.numpy(), np.eye(3), atol=0)
    np.testing.assert_allclose(pwb.numpy(), np.zeros(3), atol=0)
    np.testing.assert_allclose(pose[1], np.zeros(3), atol=0)


def _first_pair():
    """The scene's frame 0 (the render of one frame only)."""
    return dataclasses.replace(SCENE, frames=1).render()[0]


@pytest.mark.parametrize("model", ["radtan", "kb8"])
def test_stereo_rectify_matches_jax(model):
    """Bouguet rectification from the factory calibration (EuRoC radtan,
    TUM-VI KB8): maps, intrinsics, baseline and rotations equal to JAX's
    (the same float64 numpy); `apply_undistort` through the left map equal."""
    if model == "radtan":
        c0, c1 = teuroc.EUROC_CAM0, teuroc.EUROC_CAM1
        args = (c0["params"], c0["distortion"], c1["params"], c1["distortion"])
    else:
        c0, c1 = teuroc.TUMVI_CAM0, teuroc.TUMVI_CAM1
        args = (c0["params"][:4], c0["params"][4:], c1["params"][:4], c1["params"][4:])
    R, t = trect.relative_pose_from_body(c0["T_BS"], c1["T_BS"])
    Rj, tj = jrect.relative_pose_from_body(c0["T_BS"], c1["T_BS"])
    np.testing.assert_array_equal(R, Rj)
    got = trect.stereo_rectify(*args, R, t, c0["resolution"], model=model)
    ref = jrect.stereo_rectify(*args, Rj, tj, c0["resolution"], model=model)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    img = np.random.default_rng(0).uniform(0, 255, c0["resolution"]).astype(np.float32)
    np.testing.assert_array_equal(teuroc.apply_undistort(img, got[0]),
                                  jeuroc.apply_undistort(img, ref[0]))


PRESETS = ("euroc_mono", "euroc_mono_inertial", "euroc_stereo", "euroc_stereo_rectified",
           "euroc_stereo_inertial", "euroc_rgbd", "tumvi_mono", "tumvi_mono_inertial",
           "tumvi_stereo_inertial")


def _same(got, ref, path):
    """Every field of the port's config object equal to JAX's (the port's
    InertialConfig has every field but `max_factors`, a jit-shape pad)."""
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(ref).__name__, path
        names = {f.name for f in dataclasses.fields(got)}
        assert {f.name for f in dataclasses.fields(ref)} - names <= {"max_factors"}, path
        for n in sorted(names):
            _same(getattr(got, n), getattr(ref, n), f"{path}.{n}")
    elif isinstance(got, (tuple, list, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=path)
    else:
        assert got == ref, (path, got, ref)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax_and_builds(name):
    """The preset's return value field by field against JAX's (rectification
    maps equal), and the port's System for it builds on the CPU (the class
    the preset is for; `_check_ported` refuses none of them)."""
    got, ref = getattr(tpresets, name)(), getattr(jpresets, name)()
    got_t = got if isinstance(got, tuple) else (got,)
    ref_t = ref if isinstance(ref, tuple) else (ref,)
    assert len(got_t) == len(ref_t)
    for n, (g, r) in enumerate(zip(got_t, ref_t)):
        _same(g, r, f"{name}[{n}]")
    cfg = dataclasses.replace(got_t[0], enable_relocalization=False)
    rest = got_t[1:]
    if "inertial" in name and "stereo" in name:
        sys_ = tsi.StereoInertialSystem(cfg, rest[0], rest[1], device="cpu")
    elif "inertial" in name:
        sys_ = tis.InertialSystem(cfg, rest[0], device="cpu")
    elif "rgbd" in name:
        sys_ = trgbd.RGBDSystem(cfg, rest[0], device="cpu")
    elif "stereo" in name:
        sys_ = tss.StereoSystem(cfg, rest[0], device="cpu")
    else:
        sys_ = tsystem.System(cfg, device="cpu")
    assert sys_.state == tsystem.NO_IMAGES_YET and sys_.cfg.cam_model in ("pinhole", "kb8")


def _drive_si(scn, sys_):
    imgs = scn.render()
    d = ss.drive(sys_, range(scn.frames), ss.fisheye_si_step(scn, imgs))
    return ss.check_fisheye_si_gates(scn, sys_, d)


@pytest.mark.slow
def test_raw_fisheye_stereo_inertial_drive():
    """tests/test_fisheye_direct_stereo.py:137's 70-frame drive on the
    port's StereoInertialSystem with its gates: no reset, OK at the end, the
    IMU initialized, rigid RMSE < 0.10, |s - 1| < 0.05."""
    c, ic, sc = SCENE.configs()
    bad, st = _drive_si(SCENE, tsi.StereoInertialSystem(c, ic, sc, device="cpu"))
    assert bad == [], (bad, st)


@pytest.mark.slow
def test_phase_11c_fisheye_stereo_inertial_with_the_tumvi_camera():
    """Phase 11c's drive on the CPU: the same drive with the TUM-VI camera
    (KB8 of TUM-VI cam0 at 512x512, 1000 features) through the JAX and the
    port's StereoInertialSystem; both hold the test's gates, from the same
    first-pair map size."""
    out = {}
    scn = ss.FisheyeSIScene()
    tc, tic, tsc = scn.configs()
    jc, jic, jsc = (H.jax_config(c) for c in (tc, tic, tsc))
    for name, sys_ in (("jax", jsi.StereoInertialSystem(jc, jic, jsc)),
                       ("port", tsi.StereoInertialSystem(tc, tic, tsc, device="cpu"))):
        bad, out[name] = _drive_si(scn, sys_)
        print(name, out[name])
        assert bad == [], (name, bad)
    assert out["port"]["n_init_points"] == out["jax"]["n_init_points"]
