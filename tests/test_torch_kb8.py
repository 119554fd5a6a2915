"""The port's Kannala-Brandt-8 fisheye against the JAX package's: the camera
model (projection, the 10-step Newton unprojection, the projection's
Jacobian) out to the edge of the forward hemisphere, the ray-space epipolar
gate and triangulation of the keyframe step, the bearing-space two-view
reconstruction of `System._initialize` with JAX's RANSAC samples injected,
and MLPnP on KB8 rays.  The port's drive of tests/test_kb8_pipeline.py is
marked slow, as its twin is, and so is phase 11d of `chip_smoke.py` (the
JAX `System` and the port's on a fisheye render of bench.py's path), which
gives that phase its bounds.  Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.geometry import mlpnp as jmlpnp
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu_torch.geometry import mlpnp as tmlpnp
from orbslam3_tpu_torch.ops import cameras as tcam
from orbslam3_tpu_torch.pipeline import mapping as tmapping
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.utils import align as talign
from test_kb8_pipeline import HW, KB8, FisheyeWorld
from test_loop_integration import make_ff
from test_torch_twoview import _jax_idx

torch.set_num_threads(2)

P = np.asarray(KB8, np.float32)


def _t(*arrays):
    out = [torch.from_numpy(np.array(a)) for a in arrays]
    return out[0] if len(out) == 1 else out


def _hemisphere(rng, n, theta_max, d=(0.5, 6.0)):
    """n points at polar angles up to theta_max (uniform on the sphere's cap)."""
    th = np.arccos(rng.uniform(np.cos(theta_max), 1.0, n))
    ph = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(*d, n)
    return np.stack([np.sin(th) * np.cos(ph) * r, np.sin(th) * np.sin(ph) * r,
                     np.cos(th) * r], 1).astype(np.float32)


@pytest.mark.parametrize("theta_max", [1.2, 1.55], ids=["69deg", "89deg"])
def test_kb8_camera_matches_jax(theta_max):
    """Projection within 1e-4 px, the unprojected bearing (scaled to z = 1,
    as in JAX) within 1e-6 in direction (its x and y grow as tan(theta)
    toward the hemisphere's edge, where one ulp of theta is 4e-6 of them),
    the Jacobian within 1e-6 of its largest entry; on the axis (r < 1e-9)
    the principal point and a zero Jacobian, as JAX gives them."""
    rng = np.random.default_rng(int(theta_max * 100))
    X = _hemisphere(rng, 400, theta_max)
    X[:2] = [[0.0, 0.0, 2.0], [1e-12, 0.0, 1.0]]
    uv_j = np.asarray(jcam.kb8_project(P, X))
    np.testing.assert_allclose(tcam.kb8_project(_t(P), _t(X)).numpy(), uv_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(uv_j[:2], np.tile(P[2:4], (2, 1)), atol=1e-4)
    b_j = np.asarray(jcam.kb8_unproject(P, uv_j))
    b_t = tcam.kb8_unproject(_t(P), _t(uv_j)).numpy()
    unit = lambda b: b / np.linalg.norm(b, axis=1, keepdims=True)
    np.testing.assert_allclose(unit(b_t), unit(b_j), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(b_t[:, 2], 1.0)
    # the bearing points at the point it came from
    cos = np.sum(b_t * X, 1) / np.linalg.norm(b_t, axis=1) / np.linalg.norm(X, axis=1)
    assert cos.min() > 1 - 1e-6
    J_j = np.asarray(jcam.kb8_project_jac(P, X))
    J_t = tcam.kb8_project_jac(_t(P), _t(X)).numpy()
    assert np.abs(J_t - J_j).max() <= 1e-6 * np.abs(J_j).max()
    assert not J_t[:2].any() and not J_j[:2].any()


def _two_views(seed, n=300, noise=0.3):
    """Points of a dome seen by two KB8 keyframes 0.4 apart: (frames as port
    and JAX FeatureFrames, poses, the points)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-6, 6, n), rng.uniform(-5, 5, n), rng.uniform(1.5, 7, n)],
                 1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    R1 = np.eye(3, dtype=np.float32)
    t1 = np.zeros(3, np.float32)
    R2 = np.asarray(jlie.exp_so3(jnp.asarray([0.02, -0.05, 0.01])), np.float32)
    t2 = (-R2 @ np.array([0.4, 0.05, 0.02])).astype(np.float32)
    frames = []
    for R, t in ((R1, t1), (R2, t2)):
        uv = np.asarray(jcam.kb8_project(P, X @ R.T + t))
        frames.append(make_ff((uv + noise * rng.standard_normal(uv.shape)).astype(np.float32),
                              desc, 512))
    return frames, (R1, t1, R2, t2), X


@pytest.mark.parametrize("seed", [0, 1])
def test_kb8_triangulation_matches_jax(seed):
    """`triangulate_new_points` with the KB8 camera: the ray-space epipolar
    gate (bearings on the unit virtual pinhole, sigma^2 / f^2) and the
    ray DLT.  The same accepted set, the same matched keypoints, points
    within 1e-4 relative; most of the dome is triangulated within 5% of its
    true position."""
    (fj_a, fj_b), (R1, t1, R2, t2), X = _two_views(seed)
    unm = jnp.ones(512, bool)
    ref = jmapping.triangulate_new_points(fj_b, fj_a, unm, unm, R2, t2, R1, t1, "kb8", P, P[:4])
    ft_a, ft_b = (convert.frame_from_numpy(H.fields(f)) for f in (fj_a, fj_b))
    on = torch.ones(512, dtype=torch.bool)
    got = tmapping.triangulate_new_points(ft_b, ft_a, on, on, *_t(R2, t2, R1, t1), "kb8", _t(P),
                                          _t(P[:4]))
    ok = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    np.testing.assert_array_equal(got.kp_prev.numpy()[ok], np.asarray(ref.kp_prev)[ok])
    Xr = np.asarray(ref.xyz)[ok]
    rel = np.linalg.norm(got.xyz.numpy()[ok] - Xr, axis=1) / np.linalg.norm(Xr, axis=1)
    assert rel.max() < 1e-4
    assert ok.sum() > 200
    err = np.linalg.norm(Xr - X[np.nonzero(ok)[0]], axis=1) / np.linalg.norm(Xr, axis=1)
    assert np.median(err) < 0.05


def _kb8_cfg(pkg):
    return pkg.SlamConfig(cam_model="kb8", cam_params=KB8, image_hw=HW,
                          enable_relocalization=False)


@pytest.mark.parametrize("key", [3, 4])
def test_bearing_space_reconstruct_matches_jax(key):
    """`System._initialize`'s two-view reconstruction for a KB8 camera: F and H
    on the bearings over a unit virtual pinhole with sigma = 1 / fx
    (system.py:212-228), the port drawing JAX's samples.  The same outcome,
    model and triangulated set, R21 and t21 within 1e-4, points within 1e-3
    relative; the motion is the true one up to scale."""
    (fj_a, fj_b), (R1, t1, R2, t2), X = _two_views(key + 10, noise=0.2)
    jsys = jsystem.System(_kb8_cfg(jsystem))
    tsys = tsystem.System(_kb8_cfg(tsystem), device="cpu")
    xy1, xy2 = np.asarray(fj_a.xy), np.asarray(fj_b.xy)
    valid = np.asarray(fj_a.valid)
    ref = jsys._reconstruct(jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
                            jax.random.PRNGKey(key))
    got = tsys._reconstruct(*_t(xy1, xy2, valid), idx=torch.from_numpy(_jax_idx(valid, key).copy()))
    assert bool(got.success) and bool(ref.success)
    assert bool(got.used_homography) == bool(ref.used_homography)
    tri = np.asarray(ref.triangulated)
    np.testing.assert_array_equal(got.triangulated.numpy(), tri)
    assert tri.sum() > 200
    np.testing.assert_allclose(got.R21.numpy(), np.asarray(ref.R21), atol=1e-4)
    np.testing.assert_allclose(got.t21.numpy(), np.asarray(ref.t21), atol=1e-4)
    Xr = np.asarray(ref.points3d)[tri]
    rel = np.linalg.norm(got.points3d.numpy()[tri] - Xr, axis=1) / np.linalg.norm(Xr, axis=1)
    assert rel.max() < 1e-3
    np.testing.assert_allclose(got.R21.numpy(), R2, atol=5e-3)
    t_true = t2 / np.linalg.norm(t2)
    assert float(np.dot(got.t21.numpy() / np.linalg.norm(got.t21.numpy()), t_true)) > 0.99


@pytest.mark.parametrize("seed", [0, 1])
def test_mlpnp_on_kb8_rays_matches_jax(seed):
    """MLPnP through the KB8 dispatch (relocalization on a fisheye map:
    `geometry/mlpnp.py` unprojects with the camera model, `pnp.py` likewise),
    30% outliers, 300 hypotheses from JAX's draw: the same inlier set, R
    within 1e-4, t within 1e-3 relative, and the true pose."""
    rng = np.random.default_rng(seed + 40)
    n = 300
    X = _hemisphere(rng, n, 1.3, d=(2.0, 8.0))
    R = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.1, 3))), np.float32)
    t = rng.normal(0, 0.3, 3).astype(np.float32)
    Xw = ((X - t) @ R).astype(np.float32)             # X = R Xw + t in the camera
    uv = np.asarray(jcam.kb8_project(P, X)) + 0.5 * rng.standard_normal((n, 2))
    bad = rng.random(n) < 0.3
    uv[bad] = rng.uniform(40, 470, (bad.sum(), 2))
    uv = uv.astype(np.float32)
    valid = np.ones(n, bool)
    is2 = np.ones(n, np.float32)
    key = jax.random.PRNGKey(seed)
    rj = jmlpnp.solve_mlpnp(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), "kb8", P, key,
                            iterations=300, inv_sigma2=jnp.asarray(is2))
    idx = H.jax_mlpnp_samples(key, valid, is2, 300)
    rt = tmlpnp.solve_mlpnp(*_t(Xw, uv, valid), "kb8", _t(P), idx=_t(idx), iterations=300,
                            inv_sigma2=_t(is2))
    assert bool(rt.success) and bool(rj.success)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t),
                               atol=1e-3 * max(1.0, np.abs(t).max()))
    np.testing.assert_allclose(rt.R.numpy(), R, atol=5e-3)
    assert not rt.inliers.numpy()[bad].mean() > 0.05


@pytest.mark.slow
class TestKB8Pipeline:
    def test_fisheye_mono_sequence(self):
        """tests/test_kb8_pipeline.py's 50-frame fisheye drive on the port's
        `System`, with its gates: no reset, OK at the end, ATE after Umeyama
        with scale below 0.06."""
        world = FisheyeWorld(seed=5)
        poses = []
        for i in range(50):
            yaw = 0.08 * np.sin(i * 0.06)
            Rwc = np.asarray(jlie.exp_so3(jnp.array([0.0, yaw, 0.0])))
            twc = np.array([0.06 * i, 0.2 * np.sin(i * 0.1), 0.0])
            R_cw = Rwc.T.astype(np.float32)
            poses.append((R_cw, (-R_cw @ twc).astype(np.float32), twc))
        cfg = tsystem.SlamConfig(cam_model="kb8", cam_params=KB8, image_hw=HW,
                                 min_init_matches=80, max_frames_between_kf=8,
                                 ba_caps=(24, 4096, 16384))
        sys_ = tsystem.System(cfg, device="cpu")
        for i, (R_cw, t_cw, _) in enumerate(poses):
            ff = convert.frame_from_numpy(H.fields(world.frame(R_cw, t_cw)))
            sys_.track_monocular(None, ts=i * 0.05, features=ff)
        assert sys_.n_resets == 0
        assert sys_.state == tsystem.OK
        est = np.stack([p[2] for p in sys_.trajectory])
        gt = np.stack([poses[int(round(t / 0.05))][2] for t, _, _ in sys_.trajectory])
        rmse, _, _, _ = talign.ate_rmse(est, gt)
        assert float(rmse) < 0.06, float(rmse)


@pytest.mark.slow
def test_phase_11d_kb8_monocular_on_bench_path():
    """Phase 11d's drive on the CPU at full size: the TUM-VI camera
    (`config.tumvi_mono`, KB8 at 512x512, 1000 features) on
    `sensor_scene.render_fisheye_frames`' views of bench.py's 78 frames,
    through the JAX and the port's `track_monocular`.  Both initialize by
    `sensor_scene.FISHEYE_INIT_BY` and stay OK after, with no reset, every
    tracked frame at `min_track_inliers` or more, and an ATE after Umeyama
    with scale below FISHEYE_MAX_ATE_RATIO of the span; both initialize at
    the same frame."""
    from orbslam3_tpu_torch.utils import seeded_scene as scene
    from orbslam3_tpu_torch.utils import sensor_scene as ss
    cfg = dataclasses.replace(scene.SceneConfig(), seed_frames=(), track_frames=tuple(range(78)))
    fcfg = ss.fisheye_config()
    frames = ss.render_fisheye_frames(cfg, fcfg)
    out = {}
    for name, sys_ in (("jax", jsystem.System(H.jax_config(fcfg))),
                       ("port", tsystem.System(fcfg, device="cpu"))):
        d = ss.drive(sys_, cfg.track_frames, ss.mono_step(frames))
        rmse, s, span = scene.system_ate(sys_)
        inl = [x for x in d.inliers[d.init_frame + 1:] if x is not None]
        out[name] = dict(init_frame=d.init_frame, ate=rmse, scale=s, ratio=rmse / span,
                         min_inliers=min(inl), n_kf=sys_.n_kf_host)
        print(name, out[name])
        assert 0 <= d.init_frame <= ss.FISHEYE_INIT_BY
        assert all(st == tsystem.OK for st in d.states[d.init_frame:])
        assert sys_.n_resets == 0 and min(inl) >= fcfg.min_track_inliers
        assert rmse / span < ss.FISHEYE_MAX_ATE_RATIO
    assert out["port"]["init_frame"] == out["jax"]["init_frame"]
