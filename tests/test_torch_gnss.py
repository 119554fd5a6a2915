"""The port's GNSS georeferencing against the JAX package's: the WGS84 ->
EPSG3857 conversion, the sliding-window Umeyama georeference, the position
residuals, the GNSS-constrained BA (`System._gnss_ba`: the capacity-wide
temporal window with position priors through the COO solver) on a
JAX-built map, the georeference riding an IMU-initialization world Sim3
(`InertialSystem._apply_world_sim3`), and the port's own 80-frame drive
held to `tests/test_gnss.py`'s gates.  Each test states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.geometry import georef as jgeo
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import inertial_system as jis
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.geometry import georef as tgeo
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path
from test_torch_gba import CAP, N_KF, N_PT, _jax_map

torch.set_num_threads(2)


def test_wgs84_to_epsg3857_matches_jax():
    """The same float64 numpy on a grid of latitudes and longitudes (equal),
    and 1 degree of longitude on the equator is 111.32 km."""
    lat, lon = np.meshgrid(np.linspace(-80, 80, 17), np.linspace(-180, 180, 25))
    for got, ref in zip(tgeo.wgs84_to_epsg3857(lat, lon), jgeo.wgs84_to_epsg3857(lat, lon)):
        np.testing.assert_array_equal(got, ref)
    x0, _ = tgeo.wgs84_to_epsg3857(np.array(0.0), np.array(8.0))
    x1, _ = tgeo.wgs84_to_epsg3857(np.array(0.0), np.array(9.0))
    assert abs((x1 - x0) - 111319.49) < 1.0


def _fixes(n, spread=5.0, seed=0):
    rng = np.random.default_rng(seed)
    slam = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    Rg = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.0, 0.7])))
    gnss = (12.0 * slam @ Rg.T + np.array([1000.0, 2000.0, 30.0])).astype(np.float32)
    return slam, gnss


@pytest.mark.parametrize("case", ["fit", "window", "too_few", "no_spread"])
def test_georeferencer_matches_jax(case):
    """The same fixes into both referencers (`min_kfs` 10, window 50): a fit
    of 30 fixes and one of the last 50 of 60 give R within 1e-5, s within
    1e-5 relative, t and `apply` within 1e-3 (geo coordinates near 2000 in
    float32), and land on the fixes within 1e-2 (test_atlas_reloc's
    `test_umeyama_georeference`); 9 fixes, or positions spread less than
    `min_spread`, leave both uninitialized."""
    n = dict(fit=30, window=60, too_few=9, no_spread=30)[case]
    slam, gnss = _fixes(n, spread=0.01 if case == "no_spread" else 5.0)
    ref, got = jgeo.GeometricReferencer(min_kfs=10), tgeo.GeometricReferencer(min_kfs=10)
    for a, b in zip(slam, gnss):
        ref.add_fix(a, b)
        got.add_fix(a, b)
    Tr, Tg = ref.update(), got.update()
    assert len(got._slam) == len(ref._slam) == min(n, 50)
    if case in ("too_few", "no_spread"):
        assert Tr is None and Tg is None and not got.initialized
        return
    assert got.initialized
    np.testing.assert_allclose(Tg.R.numpy(), np.asarray(Tr.R), atol=1e-5)
    assert float(Tg.s) == pytest.approx(float(Tr.s), rel=1e-5)
    np.testing.assert_allclose(Tg.t.numpy(), np.asarray(Tr.t), atol=1e-3)
    out = got.apply(torch.from_numpy(slam)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref.apply(jnp.asarray(slam))), atol=1e-3)
    np.testing.assert_allclose(out, gnss, atol=1e-2)


def test_gnss_position_residuals_match_jax():
    """Weighted residuals (p - fix) / sigma where a keyframe has a fix, 0
    elsewhere: within 1e-6."""
    rng = np.random.default_rng(1)
    p, g = (rng.normal(size=(16, 3)).astype(np.float32) for _ in range(2))
    has = rng.random(16) < 0.5
    ref = jgeo.gnss_position_residuals(jnp.asarray(p), jnp.asarray(g), jnp.asarray(has), 0.3)
    got = tgeo.gnss_position_residuals(torch.from_numpy(p), torch.from_numpy(g),
                                       torch.from_numpy(has), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_gnss_ba_matches_jax():
    """`System._gnss_ba` on `_jax_map`'s map and bank (8 keyframes, 300
    points, every keyframe but one with a prior 0.2 from its true centre at
    the weight that `_gnss_keyframe_stage` gives sigma 0.05): every keyframe
    pose within 1e-3, every point within 1e-3 of the map's extent; the
    priors move the keyframes (by 3.7e-3 against the same BA with zero
    weights; the 2 fixed anchors hold the gauge and 300 points' reprojections
    hold the rest), held at > 1e-3."""
    jm, jb = _jax_map(seed=2)
    rng = np.random.default_rng(3)
    K = CAP["n_kf"]
    centres = np.stack([[0.25 * k, 0.0, 0.0] for k in range(N_KF)]).astype(np.float32)
    prior_pos = np.zeros((K, 3), np.float32)
    prior_pos[:N_KF] = centres + rng.normal(0, 0.2, (N_KF, 3)).astype(np.float32)
    prior_w = np.zeros(K, np.float32)
    prior_w[:N_KF] = 1.0 / 0.05 ** 2
    prior_w[4] = 0.0                                 # a keyframe without a fix
    kw = dict(cam_params=K4, enable_relocalization=False, gnss_ba_cams=16)
    ref = jsystem.System(jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **kw))._gnss_ba(
        jm, jnp.asarray(N_KF - 1, jnp.int32), jnp.asarray(prior_pos), jnp.asarray(prior_w), jb)
    tcfg = tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **kw)
    got = tsystem.gnss_ba(tcfg, torch.tensor(K4), convert.map_from_numpy(H.fields(jm)),
                          N_KF - 1, torch.from_numpy(prior_pos), torch.from_numpy(prior_w),
                          convert.bank_from_numpy(H.fields(jb)))
    g, r = convert.to_numpy(got), H.fields(ref)
    for name in ("kf_R", "kf_t"):
        np.testing.assert_allclose(g[name][:N_KF], r[name][:N_KF], atol=1e-3, err_msg=name)
    scale = np.abs(r["pt_xyz"][:N_PT]).max()
    assert np.abs(g["pt_xyz"][:N_PT] - r["pt_xyz"][:N_PT]).max() < 1e-3 * scale

    # the priors count: without them the same BA lands elsewhere
    free = tsystem.gnss_ba(tcfg, torch.tensor(K4), convert.map_from_numpy(H.fields(jm)),
                           N_KF - 1, torch.from_numpy(prior_pos), torch.zeros(K),
                           convert.bank_from_numpy(H.fields(jb)))
    assert np.abs(free.kf_t.numpy() - g["kf_t"]).max() > 1e-3


def test_apply_world_sim3_moves_the_georeference_window():
    """test_gnss's `test_world_sim3_transforms_the_umeyama_window` on both
    InertialSystems: 8 fixes at 1/7 of metric, the georeference fitted, then
    the IMU initialization's world Sim3 (7, Rg) applied; the refitted
    transform maps the re-anchored SLAM positions onto the geo frame (scale
    3 within 1e-3 relative, a fix within 1e-2), and the port's R, t and s
    equal JAX's within 1e-5 (t within 1e-4 relative)."""
    cfgs = [mod.SlamConfig(cam_params=K4, image_hw=HW, enable_gnss=True, gnss_min_kfs=6,
                           map_capacity=cap)
            for mod, cap in ((jsystem, jstate.MapCapacity(**CAP)), (tsystem, MapCapacity(**CAP)))]
    jsys = jis.InertialSystem(cfgs[0], jis.InertialConfig(imu_freq=200.0))
    tsys = tis.InertialSystem(cfgs[1], tis.InertialConfig(imu_freq=200.0), device="cpu")
    rng = np.random.default_rng(0)
    s_geo, t_geo = 3.0, np.array([100.0, -50.0, 10.0])
    Rgeo = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.0, 0.6])))
    pts = rng.normal(0, 2.0, (8, 3))
    for p in pts:
        for s_ in (jsys, tsys):
            s_.georef.add_fix((p / 7.0).astype(np.float32),
                              (s_geo * (Rgeo @ p) + t_geo).astype(np.float32))
    Rg = np.array(jlie.exp_so3(jnp.asarray([0.05, -0.1, 0.3])), np.float32)
    jsys.georef.update()
    tsys.georef.update()
    jsys._apply_world_sim3(jnp.asarray(Rg), 7.0)
    tsys._apply_world_sim3(torch.from_numpy(Rg), 7.0)
    tr, jr = tsys.georef.transform, jsys.georef.transform
    assert float(tr.s) == pytest.approx(s_geo, rel=1e-3)
    p_new = (7.0 * Rg @ (pts[0] / 7.0)).astype(np.float32)
    np.testing.assert_allclose(float(tr.s) * tr.R.numpy() @ p_new + tr.t.numpy(),
                               s_geo * (Rgeo @ pts[0]) + t_geo, atol=1e-2)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-5)
    assert float(tr.s) == pytest.approx(float(jr.s), rel=1e-5)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), rtol=1e-4)
    np.testing.assert_allclose(np.stack(tsys.georef._slam), np.stack(jsys.georef._slam),
                               atol=1e-6)


def test_georef_init_and_gnss_ba_drive():
    """test_gnss's `test_georef_init_and_gnss_ba` on the port at a
    32-keyframe capacity: 80 frames with fixes that are the true camera
    centres in a geo frame 7x scaled, 0.8 rad rotated and 4.5e6 offset, with
    0.02 noise.  Its gates: no reset, the georeference initialized with a
    finite positive scale, the geo-frame trajectory within an RMSE of 0.5 of
    the true geo track, every keyframe pose finite; and GNSS BAs posted and
    every one merged."""
    world = SyntheticWorld(seed=4)
    n = 80
    poses = camera_path(n)
    cfg = tsystem.SlamConfig(
        cam_params=K4, image_hw=HW, max_frames_between_kf=5, ba_caps=(24, 4096, 16384),
        enable_gnss=True, gnss_min_kfs=6, gnss_ba_every=2, gnss_sigma=0.05,
        gnss_time_tol=0.03, map_capacity=MapCapacity(n_kf=32, n_pt=4096, n_obs=32768),
        local_view_points=2048, enable_relocalization=False)
    sys_ = tsystem.System(cfg, device="cpu")
    th = 0.8
    R_geo = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    s_geo, t_geo = 7.0, np.array([4.5e6, 1.1e6, 320.0])
    rng = np.random.default_rng(2)
    gt_geo = []
    for i, (R, t, _) in enumerate(poses):
        ts = i * 0.05
        geo = s_geo * (R_geo @ (-np.asarray(R).T @ np.asarray(t))) + t_geo
        gt_geo.append(geo)
        sys_.grab_gnss(ts, geo + rng.normal(0, 0.02, 3))
        sys_.track_monocular(None, ts=ts, features=convert.frame_from_numpy(
            H.fields(world.frame(R, t))))
    sys_.shutdown()
    assert sys_.n_resets == 0
    assert sys_.georef.initialized
    s = float(sys_.georef.transform.s)
    assert np.isfinite(s) and s > 0.0
    geo = sys_.trajectory_geo()
    gt = np.stack([gt_geo[int(round(p[0] / 0.05))] for p in sys_.trajectory])
    err = np.linalg.norm(geo - gt, axis=1)
    assert float(np.sqrt((err ** 2).mean())) < 0.5, err.mean()
    assert bool(torch.isfinite(sys_.map.kf_t[:sys_.n_kf_host]).all())
    c = sys_.chain_counts
    assert sys_.n_gnss_ba >= 2 and c["posted gba"] == sys_.n_gnss_ba
    assert c["merged gba at a poll"] + c["merged gba forced"] == sys_.n_gnss_ba
