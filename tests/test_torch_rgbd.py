"""The port's `RGBDSystem` against the JAX package's: the depth image sampled
at the keypoints' nearest pixels into a virtual right coordinate
(tests/test_rgbd.py:69-99, with keypoints at exact half pixels, which both
round half to even), the `stereo_bf == fx * baseline` guard, and the first
frame's metric map.  The feature drive of TestRGBDPipeline and phase 11b of
`chip_smoke.py` (the JAX and the port's RGBDSystem on bench.py's path with
the plane's depth images, which gives that phase its bounds) are marked
slow.  Each test states its tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.pipeline import rgbd_system as jrgbd
from orbslam3_tpu.pipeline import stereo_system as jss
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu_torch.pipeline import rgbd_system as trgbd
from orbslam3_tpu_torch.pipeline import stereo_system as tss
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.utils import align as talign
from orbslam3_tpu_torch.utils import seeded_scene as scene
from orbslam3_tpu_torch.utils import sensor_scene as ss
from test_pipeline_e2e import HW, K4
from test_rgbd import BASELINE, FX, PLANE_Z, PlaneWorld, small_rot
from test_torch_merge import _fields_close

torch.set_num_threads(2)


def _systems(**overrides):
    base = dict(cam_params=K4, image_hw=HW, stereo_bf=FX * BASELINE,
                enable_relocalization=False, **overrides)
    return (jrgbd.RGBDSystem(jsystem.SlamConfig(**base), jss.StereoConfig(baseline=BASELINE)),
            trgbd.RGBDSystem(tsystem.SlamConfig(**base), tss.StereoConfig(baseline=BASELINE),
                             device="cpu"))


@pytest.mark.parametrize("halves", [False, True], ids=["projected", "half-pixels"])
def test_depth_sample_matches_jax(halves):
    """The nearest-pixel sample and ur = u - bf / z: valid and depth
    bit-equal to JAX's (the same pixel), ur within 2 float32 ulp (XLA's CPU
    code rounds the quotient differently).  With
    `halves` every keypoint sits at x.5 / y.5, where round-half-to-even
    decides the pixel.  The JAX test's gate on the projected keypoints: the
    virtual ur within a median 0.5 px of the true right projection."""
    w = PlaneWorld(seed=3)
    R = small_rot(0.04, -0.03)
    t = np.array([0.2, -0.1, 0.0])
    ff, depth = w.frame(R, t, noise_px=0.0)
    if halves:
        ff = ff._replace(xy=jnp.floor(ff.xy) + 0.5)
    jsys, tsys = _systems()
    ref = jsys._rgbd_depth_jit(ff, jnp.asarray(depth))
    got = trgbd.depth_from_image(convert.frame_from_numpy(H.fields(ff)), torch.from_numpy(depth),
                                 tsys.bf, tsys.max_depth)
    for name in ("valid", "depth"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.ur.numpy(), np.asarray(ref.ur), rtol=2.5e-7, atol=0)
    ok = got.valid.numpy()
    assert ok.sum() > 200
    if halves:
        return
    xy = np.asarray(ff.xy)[ok]
    rays = np.stack([(xy[:, 0] - K4[2]) / K4[0], (xy[:, 1] - K4[3]) / K4[1], np.ones(len(xy))], 1)
    O_w = -R.T @ t
    z_true = (PLANE_Z - O_w[2]) / (rays @ R)[:, 2]
    assert np.median(np.abs(got.ur.numpy()[ok] - (xy[:, 0] - FX * BASELINE / z_true))) < 0.5


@pytest.mark.parametrize("bf_scale", [1.0, 1.01])
def test_stereo_bf_guard(bf_scale):
    """RGBDSystem refuses a stereo_bf other than fx * baseline (relative
    1e-4) with ValueError, as JAX does, and accepts the matching one."""
    base = dict(cam_params=K4, image_hw=HW, stereo_bf=FX * BASELINE * bf_scale,
                enable_relocalization=False)
    scfg = tss.StereoConfig(baseline=BASELINE)
    if bf_scale == 1.0:
        assert trgbd.RGBDSystem(tsystem.SlamConfig(**base), scfg, device="cpu").bf == \
            pytest.approx(FX * BASELINE)
        return
    with pytest.raises(ValueError, match="stereo_bf"):
        trgbd.RGBDSystem(tsystem.SlamConfig(**base), scfg, device="cpu")
    with pytest.raises(ValueError, match="stereo_bf"):
        jrgbd.RGBDSystem(jsystem.SlamConfig(**base), jss.StereoConfig(baseline=BASELINE))


def test_first_rgbd_frame_makes_the_same_map_as_jax():
    """`track_rgbd` on the first frame: the metric map from the depth image
    (stereo initialization), as JAX's: every integer field of the map and
    the bank equal, floats within 1e-5; OK, with the pose at the origin."""
    w = PlaneWorld(seed=4)
    R = small_rot(0.0, 0.0)
    ff, depth = w.frame(R, np.zeros(3), noise_px=0.3)
    jsys, tsys = _systems()
    sj, _ = jsys.track_rgbd(None, depth, 0.0, features=ff)
    st, pose = tsys.track_rgbd(None, depth, 0.0, features=convert.frame_from_numpy(H.fields(ff)))
    assert sj == st == tsystem.OK
    np.testing.assert_allclose(pose[1], np.zeros(3), atol=0)
    _fields_close(convert.to_numpy(tsys.map), H.fields(jsys.map), atol=1e-5)
    _fields_close(convert.to_numpy(tsys.bank), H.fields(jsys.bank), atol=1e-5)
    assert int(tsys.map.n_pt) > 200


@pytest.mark.slow
class TestRGBDPipeline:
    def test_metric_trajectory_without_scale_alignment(self):
        """tests/test_rgbd.py's 40-frame drive on the port's RGBDSystem with
        its gates: no reset, OK, rigid ATE < 0.02, scale within 0.01 of 1."""
        w = PlaneWorld(seed=4)
        cfg = tsystem.SlamConfig(cam_params=K4, image_hw=HW, max_frames_between_kf=8,
                                 ba_caps=(24, 4096, 16384), stereo_bf=FX * BASELINE)
        sys_ = trgbd.RGBDSystem(cfg, tss.StereoConfig(baseline=BASELINE), device="cpu")
        poses = []
        for i in range(40):
            R_cw = small_rot(0.03 * np.sin(0.25 * i), 0.02 * np.sin(0.17 * i))
            O_w = np.array([0.06 * i, 0.02 * np.sin(0.3 * i), 0.0])
            poses.append(O_w)
            ff, depth = w.frame(R_cw, -R_cw @ O_w, noise_px=0.3)
            sys_.track_rgbd(None, depth, ts=i * 0.05,
                            features=convert.frame_from_numpy(H.fields(ff)))
        assert sys_.n_resets == 0 and sys_.state == tsystem.OK
        est = np.stack([p[2] for p in sys_.trajectory])
        gt = np.stack([poses[int(round(t / 0.05))] for t, _, _ in sys_.trajectory])
        assert talign.ate_rmse(est, gt, with_scale=False)[0] < 0.02
        assert abs(talign.ate_rmse(est, gt)[1] - 1.0) < 0.01


@pytest.mark.slow
def test_phase_11b_rgbd_on_bench_path():
    """Phase 11b's drive on the CPU at full size: bench.py's 78 left frames
    with the plane's depth images through the JAX and the port's
    `track_rgbd`.  Both hold the phase's gates (`check_depth_gates` with
    `sensor_scene`'s RGBD_MAX_ATE and RGBD_MAX_SCALE_ERR), the same first-frame map size, and
    the port's rigid ATE and scale within 1e-3 of JAX's."""
    cfg = dataclasses.replace(scene.SceneConfig(), seed_frames=(), track_frames=tuple(range(78)))
    slam, st = ss.stereo_configs(cfg)
    left, depth = scene.render_frames(cfg), ss.depth_images(cfg)
    out = {}
    for name, sys_ in (("jax", jrgbd.RGBDSystem(H.jax_config(slam), H.jax_config(st))),
                       ("port", trgbd.RGBDSystem(slam, st, device="cpu"))):
        d = ss.drive(sys_, cfg.track_frames, ss.rgbd_step(left, depth))
        bad, out[name] = ss.check_depth_gates(sys_, d, ss.RGBD_MAX_ATE, ss.RGBD_MAX_SCALE_ERR)
        print(name, out[name])
        assert bad == [], (name, bad)
    assert out["port"]["n_init_points"] == out["jax"]["n_init_points"]
    assert abs(out["port"]["ate"] - out["jax"]["ate"]) < 1e-3
    assert abs(out["port"]["scale"] - out["jax"]["scale"]) < 1e-3
