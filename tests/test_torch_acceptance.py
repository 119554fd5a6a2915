"""The JAX suite's end-to-end acceptance tests, on the port.

`orbslam3_tpu_torch/utils/acceptance.py` holds the port's copy of nine slow
JAX tests (its docstring names them, A-I).  Here, for each:

* tier-1: the port's inputs against the JAX test's, built by the JAX test's
  own code (`_render`, `_stress_render`, the worlds, the IMU loop): images,
  features and IMU rows bit-equal, with one stated exception (H's ring
  poses); then a prefix of the scenario against the JAX package on the same
  inputs.  A-E: the extraction of the first images, keypoint by keypoint
  (the same keypoints; angle bins, descriptor bits and angles within the
  measured bounds stated below), and for C, D and E the scenario's numbers from
  both packages' features (C's equal, D's and E's database scores within
  1e-5 relative, the same place first).  F-I: a JAX System of the
  scenario's configuration drives itself until it has a map; the port is
  given its state (`torch_parity_helpers`) and both track the next two
  frames: poses within 1e-4, the same inliers.
* slow, as every JAX twin is: the whole scenario on the port on the CPU
  under the JAX test's gates, letter for letter
  (`test_whole_scenario_holds_the_jax_gates`).

Also the port's `render_plane` default (the JAX package's mesas) and
`acceptance.system_to` (a System copied to another device tracks as the
original does).
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_fisheye_stereo_inertial as fsi
import test_frontend_e2e as fe
import test_photometric_stress as ps
import torch_parity_helpers as H
from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.io import euroc as jeuroc
from orbslam3_tpu.io import rectify as jrect
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.ops import matching as jmatching
from orbslam3_tpu.pipeline import inertial_system as jis
from orbslam3_tpu.pipeline import loop_closing as jlc
from orbslam3_tpu.pipeline import stereo_inertial_system as jsis
from orbslam3_tpu.pipeline import stereo_system as jss
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.place import keyframe_db as jkdb
from orbslam3_tpu.utils import synth_render as jsr
from orbslam3_tpu_torch.features import extractor as tx
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import stereo_inertial_system as tsis
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.utils import acceptance as acc
from orbslam3_tpu_torch.utils import seeded_scene as ss
from orbslam3_tpu_torch.utils import synth_render as tsr
from test_inertial_pipeline import FPS, G, IMU_HZ, camera_path_smooth
from test_torch_merge import _fields_close
from test_long_run import RingWorld as JaxRingWorld
from test_pipeline_e2e import SyntheticWorld as JaxWorld
from test_pipeline_e2e import camera_path as jax_camera_path
from test_stereo import StereoWorld as JaxStereoWorld

torch.set_num_threads(2)

P = acc.orb_params()
JP = jx.OrbParams(n_features=P.n_features, n_levels=P.n_levels)
# The extraction's agreement with JAX on these images, measured over all 84
# of A-E (the sweeps' 72 frames, C's two, D's and E's five): the same
# keypoints everywhere; per image at most one keypoint in another angle bin
# and one other with one descriptor bit off (a blurred pixel rounded the
# other way at a .5 tie, T1's float order below it); angles within 0.031
# degrees.  The images are float32 with fractions (the tests hand
# `extract_jit` the clipped render, not uint8), so level 0 too sums
# non-integer pixels, in another order than JAX's: it is not bit-equal as on
# uint8 frames (test_torch_extract_levels.py).
EXTRACT_BINS_OFF = 1
EXTRACT_BITS_OFF = 1
EXTRACT_ANGLE_TOL = 0.05


def _np(x):
    return np.asarray(x)


def _jff(tff):
    """A port FeatureFrame (CPU) as the JAX package's."""
    f = convert.to_numpy(tff)
    f["desc"] = f["desc"].view(np.uint32)
    return jsystem.FeatureFrame(**{k: jnp.asarray(v) for k, v in f.items()})


def _same_frame(tff, jff):
    """A port feature frame bit-equal to a JAX one (descriptors as int32
    bit patterns of JAX's uint32)."""
    np.testing.assert_array_equal(tff.xy.numpy(), _np(jff.xy))
    np.testing.assert_array_equal(tff.desc.numpy(), _np(jff.desc).view(np.int32))
    np.testing.assert_array_equal(tff.valid.numpy(), _np(jff.valid))
    np.testing.assert_array_equal(tff.octave.numpy(), _np(jff.octave))


def _extraction_matches_jax(img, p=P, min_valid=800):
    """The image through JAX's `extract_jit` and the port's `extract`,
    keypoint by keypoint (`acc.extraction_diff`): the same keypoints on
    every level, more than `min_valid` of them; at most EXTRACT_BINS_OFF in
    another angle bin and EXTRACT_BITS_OFF descriptor bits off at the
    others, their angles within EXTRACT_ANGLE_TOL degrees."""
    fj = jx.extract_jit(jnp.asarray(img), jx.OrbParams(n_features=p.n_features,
                                                       n_levels=p.n_levels))
    ft = tx.extract(torch.from_numpy(np.asarray(img, np.float32)), p)
    f = {k: np.asarray(v) for k, v in fj._asdict().items()}
    f["desc"] = f["desc"].view(np.int32)
    d = acc.extraction_diff(ft, convert.frame_from_numpy(f))
    assert d["keypoints_equal"] and d["n_valid"] > min_valid, d
    assert d["bins_off"] <= EXTRACT_BINS_OFF and d["bits_off"] <= EXTRACT_BITS_OFF, d
    assert d["max_angle"] <= EXTRACT_ANGLE_TOL, d
    return jsystem.FeatureFrame(*(np.asarray(x) for x in fj)), ft


# ------------------------------------------------------------ the mesas default
def test_render_plane_defaults_to_the_jax_mesas():
    """The port's `render_plane` draws the JAX package's default mesas
    unless told otherwise: the same default, the same image without the
    argument."""
    dt = inspect.signature(tsr.render_plane).parameters["mesas"].default
    dj = inspect.signature(jsr.render_plane).parameters["mesas"].default
    np.testing.assert_array_equal(np.asarray(dt), np.asarray(dj))
    assert len(dt) == 24
    tex = tsr.block_texture(np.random.default_rng(5), block=10)
    R, t = acc.sweep_pose(30)
    got = tsr.render_plane(R, t, np.asarray(acc.K4), acc.HW, tex, tex_scale=40.0)
    np.testing.assert_array_equal(got, jsr.render_plane(R, t, np.asarray(acc.K4), acc.HW, tex,
                                                        tex_scale=40.0))
    assert not np.array_equal(got, tsr.render_plane(R, t, np.asarray(acc.K4), acc.HW, tex,
                                                    tex_scale=40.0, mesas=()))


def test_seeded_scene_frames_stay_bare_planes():
    """`seeded_scene`'s frames (phases 4-7, 9-11) stay the plane alone:
    bit-equal to JAX's `render_plane(..., mesas=())` with the scene's noise."""
    cfg = dataclasses.replace(ss.SceneConfig(), seed_frames=(), track_frames=(0, 21))
    frames = ss.render_frames(cfg)
    rng = np.random.default_rng(cfg.seed)
    tex = jsr.block_texture(rng, block=cfg.tex_block)
    for i in cfg.track_frames:
        img = jsr.render_plane(*ss.bench_pose(i), np.asarray(cfg.K4), cfg.hw, tex,
                               tex_scale=cfg.tex_scale, mesas=())
        img += rng.normal(0, cfg.noise_sigma, img.shape).astype(np.float32)
        np.testing.assert_array_equal(frames[i], np.clip(img, 0, 255).astype(np.uint8))


# --------------------------------------------------------------------- A, B
def _jax_sweep(stress: bool, n: int):
    """The first n frames as test_frontend_e2e (A) or
    test_photometric_stress (B) render them, and their camera centres."""
    rng = np.random.default_rng(11)
    tex = jsr.block_texture(rng, block=10)
    if stress:
        tex[:, 340:440] = 128.0
    images, centres = [], []
    for i in range(n):
        t = i / 10.0
        R_cw, t_cw = jsr.look_down_pose(0.35 * t, 0.05 * np.sin(1.7 * t), 5.0,
                                        yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))
        img = ps._stress_render(R_cw, t_cw, tex, rng, i, 36) if stress else \
            fe._render(R_cw, t_cw, tex, rng)
        images.append(np.asarray(img))
        centres.append(-R_cw.T @ t_cw)
    return images, centres


def test_b_low_texture_band_never_enters_the_view():
    """A kept gap of the reference: B's low-texture band (texture columns
    340-439, world x 8.5-11 at 40 texels per unit) lies outside every frame
    of the sweep, which sees x from about -4.1 to 5.3; in both packages each
    of the 36 frames renders the same with and without the band (the JAX
    renderer's, bit-equal to the port's: the tests above), so B stresses the
    photometry but never the texture."""
    tex = jsr.block_texture(np.random.default_rng(11), block=10)
    band = tex.copy()
    band[:, 340:440] = 128.0
    for i in range(acc.SWEEP_FRAMES):
        R, t = acc.sweep_pose(i)
        np.testing.assert_array_equal(
            jsr.render_plane(R, t, np.asarray(acc.K4), acc.HW, tex, tex_scale=40.0),
            jsr.render_plane(R, t, np.asarray(acc.K4), acc.HW, band, tex_scale=40.0))


@pytest.mark.parametrize("which", ["A", "B"])
def test_sweep_inputs_and_first_extractions_match_jax(which):
    """A and B: the first four frames bit-equal to the JAX tests' (the
    texture, the mesas, the noise drawn after each render, B's band and
    photometric regime, its blur on frames 0 and 3), the camera centres
    equal; frames 0 and 1 extracted alike."""
    stress = which == "B"
    got, gc = acc.sweep_images(stress, 4)
    ref, rc = _jax_sweep(stress, 4)
    for a, b, ca, cb in zip(got, ref, gc, rc):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ca, cb)
    for img in got[:2]:
        _extraction_matches_jax(img)


def test_b_initializes_where_its_draws_let_it():
    """B's two-view initialization depends on its RANSAC samples: with the
    System's seed (42) the port initializes at frame 12, as JAX does; with
    seed 0 at frame 21, and then only 15 of the 36 frames are OK (the whole
    drive; 2 of 12 seeds miss B's gate of 22 so on the CPU:
    `tests/acceptance_numbers.py seeds 0 12`).  That is what an H100 gave
    while a System drew its samples with a CUDA generator (15 / 36 from
    frame 21); a System now draws on the CPU on every device
    (`ops/sampling.py`), and the card initializes where the CPU does."""
    ffs = [tx.extract(torch.from_numpy(img), P) for img in acc.sweep_images(True, 22)[0]]
    for seed, n, frame in ((42, 13, 12), (0, 22, 21)):
        sys_ = tsystem.System(acc.frontend_config(), device="cpu", seed=seed)
        step = lambda s, i: s.track_monocular(None, ts=i / 10.0, features=ffs[i])
        assert acc.drive(sys_, n, step, torch.device("cpu")).init_frame == frame, seed


# ----------------------------------------------------------------------- C
def test_repeatability_inputs_extractions_and_numbers_match_jax():
    """C: both images bit-equal, both extractions alike, and the
    repeatability, recall and precision equal to what the JAX test computes
    from its own features (JAX: 0.7878, 0.4679, 0.9054)."""
    img1, img2, (R1, t1), (R2, t2) = acc.repeatability_images()
    rng = np.random.default_rng(7)
    tex = jsr.block_texture(rng, block=10)
    j1 = jsr.render_plane(R1, t1, np.asarray(acc.K4), acc.HW, tex, tex_scale=40.0, mesas=())
    j2 = jsr.render_plane(R2, t2, np.asarray(acc.K4), acc.HW, tex, tex_scale=40.0, mesas=())
    j1 = jsr.photometric_stress(j1, noise=2.0, rng=rng)
    j2 = jsr.photometric_stress(j2, exposure=1.3, gamma=0.85, vignette=0.3, noise=4.0, rng=rng)
    np.testing.assert_array_equal(img1, j1)
    np.testing.assert_array_equal(img2, j2)
    fj1, ft1 = _extraction_matches_jax(img1)
    fj2, ft2 = _extraction_matches_jax(img2)
    got = acc.repeatability(ft1, ft2, [(R1, t1), (R2, t2)])
    assert got == jax_repeatability(fj1, fj2, [(R1, t1), (R2, t2)])


def jax_repeatability(fj1, fj2, poses) -> dict:
    """The JAX test's arithmetic (test_photometric_stress.py:128-151) on two
    JAX extractions (numpy fields)."""
    (R1, t1), (R2, t2) = poses
    xy1, d1 = fj1.xy[fj1.valid], fj1.desc[fj1.valid]
    xy2, d2 = fj2.xy[fj2.valid], fj2.desc[fj2.valid]
    pred, front = ps._plane_map_xy(xy1, R1, t1, R2, t2, acc.K4)
    h, w = acc.HW
    in_img = front & (pred[:, 0] >= 8) & (pred[:, 0] < w - 8) & (pred[:, 1] >= 8) & \
        (pred[:, 1] < h - 8)
    rep = float(np.mean(np.linalg.norm(pred[in_img][:, None] - xy2[None], axis=-1)
                        .min(axis=1) < 2.0))
    mm = jmatching.match_nn(jnp.asarray(d1[in_img]), jnp.asarray(d2),
                            mask=jnp.ones((in_img.sum(), len(d2)), bool),
                            max_dist=jmatching.TH_HIGH, nn_ratio=0.9)
    mi, mv = _np(mm.idx), _np(mm.valid)
    err = np.linalg.norm(xy2[np.maximum(mi, 0)] - pred[in_img], axis=-1)
    return dict(repeatability=rep,
                recall=float(np.sum(mv & (err < 2.0)) / max(in_img.sum(), 1)),
                precision=float(np.sum(mv & (err < 3.0)) / max(mv.sum(), 1)),
                n_in_view=int(in_img.sum()))


# --------------------------------------------------------------------- D, E
def _jax_places(unseen: bool):
    """The four places and the revisit as test_frontend_e2e (D) and
    test_photometric_stress (E) render them."""
    rng = np.random.default_rng(23)
    K4, HW = acc.K4, acc.HW
    tex = jsr.voronoi_texture(rng, n_seeds=700) if unseen else jsr.block_texture(rng, block=10)
    out = []
    for x, y in acc.SPOTS:
        R_cw, t_cw = jsr.look_down_pose(x, y, 5.0)
        if unseen:
            img = jsr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex, tex_scale=40.0)
            out.append(jsr.photometric_stress(img, noise=1.5, rng=rng))
        else:
            out.append(np.asarray(fe._render(R_cw, t_cw, tex, rng)))
    R_cw, t_cw = jsr.look_down_pose(1.06, 4.46, 5.15, yaw=0.06)
    if unseen:
        img = jsr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex, tex_scale=40.0)
        out.append(jsr.photometric_stress(img, exposure=1.25, gamma=0.88, vignette=0.3,
                                          noise=4.0, rng=rng))
    else:
        out.append(np.asarray(fe._render(R_cw, t_cw, tex, rng)))
    return out


@pytest.mark.parametrize("which", ["D", "E"])
def test_place_inputs_extraction_and_query_match_jax(which):
    """D and E: the five images bit-equal; the first place extracted alike;
    the revisit's query against the four places through the trained
    65,536-word vocabulary: the same place first and the scores within 1e-5
    relative of JAX's (`LoopCloser._bow`, `keyframe_db.add` / `query` on
    each package's own features).  Near-tied TF-IDF scores may reorder the
    wrong places, so the argmax and the margin are held, as JAX's gates
    hold them (JAX: D 2.077x, E 1.857x)."""
    unseen = which == "E"
    places, revisit = acc.place_images(unseen)
    ref = _jax_places(unseen)
    for a, b in zip(places + [revisit], ref):
        np.testing.assert_array_equal(a, b)
    _extraction_matches_jax(places[0])
    lc = jlc.LoopCloser(jlc.LoopConfig(), 16)
    for k, img in enumerate(ref[:4]):
        ff = jx.extract_jit(jnp.asarray(img), JP)
        bow, _ = lc._bow(ff.desc, ff.valid)
        lc.db = jkdb.add(lc.db, k, bow)
    ff = jx.extract_jit(jnp.asarray(ref[4]), JP)
    sj = _np(jkdb.query(lc.db, lc._bow(ff.desc, ff.valid)[0])[0][:4])
    st, _ = acc.place_scores(places + [revisit], "cpu")
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=0)
    assert int(np.argmax(st)) == int(np.argmax(sj)) == acc.TRUE_PLACE
    margin = lambda s: s[acc.TRUE_PLACE] / np.delete(s, acc.TRUE_PLACE).max()
    np.testing.assert_allclose(margin(st), margin(sj), rtol=1e-5)


# ------------------------------------------------------------------- F-I
def _jax_f_inputs(n):
    """test_inertial_chain.py's frames and noisy IMU samples, drawn in its
    order: per sample the accelerometer's noise, then the gyro's."""
    world = JaxWorld(seed=5)
    frames, pos, vel, acc_, rot, rot_rate = camera_path_smooth(n)
    rng = np.random.default_rng(7)
    sg = 1.7e-4 * np.sqrt(IMU_HZ) * 10
    sa = 2.0e-3 * np.sqrt(IMU_HZ) * 10
    dt_f, dt_i = 1.0 / FPS, 1.0 / IMU_HZ
    imu, ffs = [], []
    for i in range(n):
        t_frame, rows = i * dt_f, []
        if i > 0:
            t0, k = (i - 1) * dt_f, 1
            while t0 + k * dt_i <= t_frame + 1e-9:
                tm = t0 + k * dt_i
                Rb = rot(tm - 0.5 * dt_i)
                a_body = Rb.T @ (acc_(tm - 0.5 * dt_i) - G) + rng.normal(0, sa, 3)
                w_body = rot_rate(tm - 0.5 * dt_i) + rng.normal(0, sg, 3)
                rows.append((tm, w_body, a_body))
                k += 1
        imu.append(rows)
        R_cw, t_cw, _, _ = frames[i]
        ffs.append(world.frame(R_cw, t_cw))
    return ffs, imu


def _jax_g_inputs(n):
    """test_stereo_inertial.py's stereo pairs and noiseless IMU samples."""
    world = JaxStereoWorld(seed=21)
    frames, pos, vel, acc_, rot, rot_rate = camera_path_smooth(n)
    dt_f, dt_i = 1.0 / FPS, 1.0 / IMU_HZ
    imu, pairs = [], []
    for i in range(n):
        t_frame, rows = i * dt_f, []
        if i > 0:
            t0, k = (i - 1) * dt_f, 1
            while t0 + k * dt_i <= t_frame + 1e-9:
                tm = t0 + k * dt_i
                Rb = rot(tm - 0.5 * dt_i)
                rows.append((tm, rot_rate(tm - 0.5 * dt_i), Rb.T @ (acc_(tm - 0.5 * dt_i) - G)))
                k += 1
        imu.append(rows)
        R_cw, t_cw, _, _ = frames[i]
        fl, fr, _ = world.stereo_frame(R_cw, t_cw, noise_px=0.2)
        pairs.append((fl, fr))
    return pairs, imu


def _jax_ring_poses(n):
    """test_long_run.py's ring poses (the yaw through JAX's float32 exp_so3)."""
    out = []
    for i in range(n):
        phi = 2 * np.pi * i / 240
        c = np.array([8.0 * np.cos(phi), 0.0, 8.0 * np.sin(phi)])
        Rwc = np.asarray(jlie.exp_so3(jnp.asarray([0.0, -phi + np.pi / 2, 0.0], jnp.float32)))
        R_cw = Rwc.T.astype(np.float32)
        out.append((R_cw, (-R_cw @ c).astype(np.float32), c))
    return out


def _same_imu(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert len(a) == len(b)
        for (ta, wa, aa), (tb, wb, ab) in zip(a, b):
            assert ta == tb
            np.testing.assert_array_equal(wa, wb)
            np.testing.assert_array_equal(aa, ab)


def test_feature_scene_inputs_match_jax():
    """F-I's inputs: F's frames and noisy IMU rows (10x EuRoC noise drawn in
    the test's order), G's stereo pairs and IMU rows, H's ring frames, I's
    frames, each bit-equal to the JAX tests' for the first frames.  H's one
    exception, stated: the port turns the ring's yaw into a rotation with
    its own float32 `exp_so3`, which differs from JAX's by a few float32
    ulps on 17 of the 270 poses (measured: rotations 2.4e-7, translations
    1.4e-6 apart); those frames' keypoints move by at most 3e-4 px
    (measured 2.4e-4) and nothing else changes: every frame has the same
    keypoints, descriptors and validity."""
    ffs, imu, _ = acc.f_inputs(6)
    jffs, jimu = _jax_f_inputs(6)
    for a, b in zip(ffs, jffs):
        _same_frame(a, b)
    _same_imu(imu, jimu)
    pairs, imu, _ = acc.g_inputs(4)
    jpairs, jimu = _jax_g_inputs(4)
    for (a, b), (c, d) in zip(pairs, jpairs):
        _same_frame(a, c)
        _same_frame(b, d)
    _same_imu(imu, jimu)
    ffs, centres = acc.h_inputs(270)
    jposes = _jax_ring_poses(270)
    jw = JaxRingWorld()
    n_ulp = 0
    for (R, t, c), (Rj, tj, cj), ff in zip(acc.ring_poses(270), jposes, ffs):
        np.testing.assert_allclose(R, Rj, atol=3e-7, rtol=0)
        np.testing.assert_allclose(t, tj, atol=2e-6, rtol=0)
        np.testing.assert_array_equal(c, cj)
        fj = jw.frame(Rj, tj)
        n_ulp += not np.array_equal(R, Rj)
        np.testing.assert_allclose(ff.xy.numpy(), _np(fj.xy), atol=3e-4, rtol=0)
        np.testing.assert_array_equal(ff.desc.numpy(), _np(fj.desc).view(np.int32))
        np.testing.assert_array_equal(ff.valid.numpy(), _np(fj.valid))
    assert n_ulp == 17
    jw = JaxRingWorld()
    for f, (R, t, _) in zip(ffs[:5], jposes[:5]):
        _same_frame(f, jw.frame(R, t))
    # I: camera_path's rotations come from each package's exp_so3 too
    # (synthetic_world's docstring; test_torch_drives.py holds them to 1e-6)
    ffs, poses = acc.i_inputs(6)
    jw = JaxWorld(seed=1)
    for f, (R, t, w), (Rj, tj, wj) in zip(ffs, poses, jax_camera_path(6)):
        np.testing.assert_array_equal(w, wj)
        fj = jw.frame(Rj, tj)
        if np.array_equal(R, Rj) and np.array_equal(t, tj):
            _same_frame(f, fj)
        else:
            np.testing.assert_allclose(f.xy.numpy(), _np(fj.xy), atol=2e-4, rtol=0)
            np.testing.assert_array_equal(f.valid.numpy(), _np(fj.valid))


def _tracks_alike(jsys, tsys, feed, first, n=2, twin=None):
    """Frames first..first+n-1 through both Systems (`feed(system, i)`):
    the same state, poses within 1e-4, the same inliers; `twin` (a copy of
    the port's System) bit-equal to it."""
    for i in range(first, first + n):
        for s in (jsys, tsys) + ((twin,) if twin is not None else ()):
            feed(s, i)
        assert jsys.state == tsys.state == jsystem.OK, i
        np.testing.assert_allclose(tsys.R_cur.numpy(), _np(jsys.R_cur), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tsys.t_cur.numpy(), _np(jsys.t_cur), atol=1e-4, rtol=0)
        assert tsys.last_track_inliers == jsys.last_track_inliers >= tsys.cfg.min_track_inliers
        if twin is not None:
            assert torch.equal(twin.R_cur, tsys.R_cur) and torch.equal(twin.t_cur, tsys.t_cur)
            assert twin.last_track_inliers == tsys.last_track_inliers


def _boot(jsys, feed, limit=12):
    """Feed the JAX System until it is OK; the index of the next frame."""
    i = 0
    while jsys.state != jsystem.OK:
        assert i < limit, "the JAX System did not initialise"
        feed(jsys, i)
        i += 1
    return i


def _mono_feed(ffs, dt):
    def feed(s, i):
        ff = ffs[i] if isinstance(s, tsystem.System) else _jff(ffs[i])
        s.track_monocular(None, ts=i * dt, features=ff)
    return feed


def _inertial_feed(frames, imu, stereo):
    def feed(s, i):
        for sample in imu[i]:
            s.grab_imu(*sample)
        port = isinstance(s, tsystem.System)
        conv = (lambda f: f) if port else _jff
        if stereo:
            fl, fr = frames[i]
            s.track_stereo(None, None, ts=i / FPS, features_l=conv(fl), features_r=conv(fr))
        else:
            s.track_monocular(None, ts=i / FPS, features=conv(frames[i]))
    return feed


@pytest.mark.parametrize("which", ["F", "G"])
def test_inertial_scenario_tracks_like_jax_from_its_map(which):
    """F and G at their configurations (F: 10x EuRoC IMU noise, the VI pose
    optimization on; G: stereo-inertial): the JAX System drives itself until
    it has a map (F's monocular initialization, G's first stereo pair); the
    port's System of the same kind is given that state
    (`inertial_snapshot`, the keyframe database) and both track the next
    two frames: poses within 1e-4, the same inliers."""
    if which == "F":
        frames, imu, _ = acc.f_inputs(12)
        cfg, icfg = acc.f_configs()
        jsys = jis.InertialSystem(H.jax_config(cfg), H.jax_config(icfg))
        tsys = tis.InertialSystem(cfg, icfg, device="cpu")
    else:
        frames, imu, _ = acc.g_inputs(4)
        cfg, icfg, scfg = acc.g_configs()
        jsys = jsis.StereoInertialSystem(H.jax_config(cfg), H.jax_config(icfg),
                                         H.jax_config(scfg))
        tsys = tsis.StereoInertialSystem(cfg, icfg, scfg, device="cpu")
    feed = _inertial_feed(frames, imu, which == "G")
    first = _boot(jsys, feed)
    H.load_inertial_snapshot(H.inertial_snapshot(jsys), tsys)
    H.copy_keyframe_db(jsys, tsys)
    _tracks_alike(jsys, tsys, feed, first)


@pytest.mark.parametrize("which", ["H", "I"])
def test_mono_scenario_tracks_like_jax_from_its_map(which):
    """H (the ring lap, loop closing on) and I (the synthetic sequence) at
    their configurations: the JAX System initializes itself; the port's is
    given its state and database (`copy_system_state`) and both track the
    next two frames: poses within 1e-4, the same inliers.  A copy of the
    port's System made by `acceptance.system_to` tracks them bit for bit as
    the port's does."""
    if which == "H":
        (ffs, _), cfg, dt = acc.h_inputs(8), acc.h_config(), 0.05
    else:
        (ffs, _), cfg, dt = acc.i_inputs(8), acc.i_config(), 0.05
    jsys = jsystem.System(H.jax_config(cfg))
    tsys = tsystem.System(cfg, device="cpu")
    feed = _mono_feed(ffs, dt)
    first = _boot(jsys, feed)
    H.copy_system_state(jsys, tsys)
    H.copy_keyframe_db(jsys, tsys)
    _tracks_alike(jsys, tsys, feed, first, twin=acc.system_to(tsys, "cpu"))


def test_card_checks_hold_a_copy_against_its_original():
    """The card's checks of phase 16, run here between the CPU and a CPU
    copy: `drive(keep_copy=True)` copies the System (`system_to`) before its
    first tracked frame and `_track_check` runs that frame again on the
    copy (the same pose and inliers); `_extract_check` finds an image's
    extraction equal to itself."""
    ffs, _ = acc.i_inputs(5)
    sys_ = tsystem.System(acc.i_config(), device="cpu")
    step = lambda s, i: s.track_monocular(None, ts=i * 0.05, features=ffs[i])
    d = acc.drive(sys_, 5, step, torch.device("cpu"), keep_copy=True)
    [h] = d.held
    assert h.frame == d.init_frame + 1 and h.cpu_copy is not sys_ and h.levels is None
    bad, [out] = acc._track_check(d, step)
    assert bad == [] and out["pose"] == 0.0 and out["inliers"][0] == out["inliers"][1] > 20
    img = acc.sweep_images(False, 1)[0][0]
    bad, out = acc._extract_check(img, tx.extract(torch.from_numpy(img), P), P)
    assert bad == [] and out == dict(keypoints_equal=True, n_valid=900, bins_off=0,
                                     kp_bits_off=0, bits_off=0, max_angle=0.0)


def test_j_card_check_skips_the_tracked_frame_at_the_init_pose():
    """How J's card check holds its first tracked frame.  After the stereo
    initialization every map point's max_dist is its creation distance
    times 1.2^octave, and the first tracked frame's guess is the
    initialization's pose, so every predicted scale level,
    ceil(log(max_dist / dist) / log 1.2), is taken within 1e-5 of an
    integer, some of them just above it (`tests/acceptance_numbers.py
    floats` prints how many).  A float rounding decides the level there: on
    an H100 that frame's pose came out 1.3e-3 from the CPU's, with 299
    inliers against 298.  So `drive(keep_copy=True, hold=2, with_levels=1)`
    records that step's predicted levels (`predicted_levels`) beside two
    CPU copies of the state before it, and `_track_check` runs the frame on
    one copy as it is and on the other with the recorded levels played in
    place of its own, then the second tracked frame as it is.  Here the
    "card" is a CPU System that predicts its levels in float64, which rounds
    some of them apart from float32: without its levels the copy misses
    (measured: 6.3e-3, 300 inliers against 299), with them it agrees
    exactly.  A played tape replaces what `tracking.predict_scale` and
    fusion's name for it compute, counts the levels it changed, and
    restores both."""
    from orbslam3_tpu_torch.pipeline import fusion, tracking
    rect = acc.j_rectification()
    pairs = acc.j_pairs(range(3), rect)
    sys_ = tsis.StereoInertialSystem(*acc.j_configs(rect), device="cpu")
    sys_.track_stereo(*pairs[0], ts=0.0)
    v = sys_.view
    dist = torch.linalg.norm(v.xyz @ sys_.R_cur.T + sys_.t_cur, dim=-1)
    lv = (torch.log(v.max_dist / dist) / torch.log(torch.tensor(1.2)))[v.valid]
    assert len(lv) > 400 and float((lv - torch.round(lv)).abs().max()) < 1e-5
    assert int((lv > torch.round(lv)).sum()) > 0

    own = tracking.predict_scale
    tape: list = []
    with acc.predicted_levels(tape):
        a = tracking.predict_scale(dist, v.max_dist, 1.2, 8)
    shifted = [torch.clamp(a + 1, 0, 7)]
    with acc.predicted_levels(shifted, play=True) as seen:
        b = fusion.predict_scale(dist, v.max_dist, 1.2, 8)
    assert tracking.predict_scale is fusion.predict_scale is own
    assert torch.equal(tape[0], a) and torch.equal(b, shifted[0])
    assert seen == {"calls": 1, "differ": int((a < 7).sum()), "mismatched": 0} and seen["differ"]

    def step(s, i):
        for sample in acc.j_imu(i):
            s.grab_imu(*sample)
        s.track_stereo(*pairs[i], ts=i / acc.J_FPS)

    def card_levels(dist, max_dist, scale_factor, n_levels):
        r = max_dist.double() / torch.clamp_min(dist.double(), 1e-6)
        lv = torch.ceil(torch.log(r) / np.log(scale_factor))
        return torch.clamp(lv, 0, n_levels - 1).to(torch.int32)

    sys_ = tsis.StereoInertialSystem(*acc.j_configs(rect), device="cpu")
    tracking.predict_scale = fusion.predict_scale = card_levels
    try:
        d = acc.drive(sys_, 3, step, torch.device("cpu"), keep_copy=True, hold=2, with_levels=1)
    finally:
        tracking.predict_scale = fusion.predict_scale = own
    assert d.init_frame == 0 and [h.frame for h in d.held] == [1, 2]
    assert len(d.held[0].levels) >= 1 and d.held[1].levels is None
    bad, (first, second) = acc._track_check(d, step)
    assert bad == [] and first["levels_differ"] > 0
    assert first["pose"] == 0.0 and first["inliers"][0] == first["inliers"][1] > 200
    plain = first["plain_inliers"]
    assert first["plain_pose"] > 1e-4 or plain[0] != plain[1], first
    assert second["pose"] == 0.0 and second["inliers"][0] == second["inliers"][1] > 200


def test_acceptance_command_line(capsys):
    """`python -m orbslam3_tpu_torch.utils.acceptance C --device cpu` runs
    scenario C and prints its JSON line (every gate held, exit 0); without
    `--device cpu` and with no card it refuses, as the tools do."""
    import json
    assert acc.main(["C", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu" and lines[1].startswith("C: ")
    r = json.loads(lines[1][3:])
    assert r["bad"] == [] and r["extracts"] == 2 and r["gates"]["repeatability"] > 0.55
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            acc.main(["C"])


# ----------------------------------------------------------------------- J
def _jax_j_setup():
    """The JAX test's rig, rectification and configurations
    (test_fisheye_stereo_inertial.py:51-73): ((cfg, icfg, scfg), (map0,
    map1, new_k4, baseline, R1))."""
    R_rel, t_rel = fsi.rig()
    map0, map1, new_k4, baseline, R1, _ = jrect.stereo_rectify(
        fsi.KB8[:4], fsi.KB8[4:], fsi.KB8[:4], fsi.KB8[4:], R_rel, t_rel, fsi.HW, model="kb8")
    cfg = jsystem.SlamConfig(
        cam_model="pinhole", cam_params=tuple(float(v) for v in new_k4), image_hw=fsi.HW,
        orb=jx.OrbParams(n_features=800, n_levels=8), max_frames_between_kf=6,
        min_init_matches=60, ba_caps=(24, 4096, 16384), stereo_bf=float(new_k4[0]) * baseline)
    Tbc = np.eye(4)
    Tbc[:3, :3] = np.asarray(R1, np.float64).T
    icfg = jis.InertialConfig(imu_freq=fsi.IMU_HZ, init_time_s=1.2, init_min_kfs=4,
                              Tbc=tuple(Tbc.reshape(-1).tolist()))
    return (cfg, icfg, jss.StereoConfig(baseline=baseline)), (map0, map1, new_k4, baseline, R1)


def _jax_j_acc_w(t):
    """The JAX test's `acc_w` (nested in the test, copied)."""
    return np.array([-0.35 * 0.49 * np.sin(0.7 * t), -0.30 * 1.21 * np.sin(1.1 * t),
                     -0.12 * 0.81 * np.sin(0.9 * t)])


def _jax_j_pos(t):
    """The JAX test's `pos` (nested in the test, copied)."""
    return np.array([0.22 * t + 0.35 * np.sin(0.7 * t), 0.30 * np.sin(1.1 * t),
                     -3.0 + 0.12 * np.sin(0.9 * t)])


def _jax_j_inputs(n, rect):
    """The JAX test's first n rectified pairs (its renders through JAX's
    `apply_undistort`) and each frame's IMU samples, in its calls and its
    order (test_fisheye_stereo_inertial.py:42-113)."""
    map0, map1 = rect[:2]
    rng = np.random.default_rng(12)
    tex = jsr.block_texture(rng, block=10)
    mesas = tuple((x0, x0 + w, y0, y0 + h, -z)
                  for x0, y0, w, h, z in
                  zip(rng.uniform(-2, 5, 10), rng.uniform(-2, 4, 10),
                      rng.uniform(0.8, 1.6, 10), rng.uniform(0.8, 1.6, 10),
                      rng.uniform(0.4, 1.0, 10)))
    R_rel, t_rel = fsi.rig()
    R_cw = np.eye(3, dtype=np.float64)
    rays_l = jsr.kb8_rays(fsi.KB8, fsi.HW)
    rays_r = jsr.kb8_rays(fsi.KB8, fsi.HW)
    dt_f, dt_i = 1.0 / fsi.FPS, 1.0 / fsi.IMU_HZ
    pairs, imu = [], []
    for i in range(n):
        t_frame, rows = i * dt_f, []
        if i > 0:
            t0, k = (i - 1) * dt_f, 1
            while t0 + k * dt_i <= t_frame + 1e-9:
                tm = t0 + k * dt_i
                rows.append((tm, np.zeros(3), R_cw @ (_jax_j_acc_w(tm - 0.5 * dt_i) - fsi.G_W)))
                k += 1
        imu.append(rows)
        t_cw_l = -R_cw @ _jax_j_pos(t_frame)
        R_cw_r = R_rel @ R_cw
        t_cw_r = R_rel @ t_cw_l + t_rel
        img_l = jsr.render_plane(R_cw, t_cw_l, fsi.KB8[:4], fsi.HW, tex, tex_scale=60.0,
                                 mesas=mesas, rays=rays_l)
        img_r = jsr.render_plane(R_cw_r, t_cw_r, fsi.KB8[:4], fsi.HW, tex, tex_scale=60.0,
                                 mesas=mesas, rays=rays_r)
        pairs.append((jeuroc.apply_undistort(img_l, map0), jeuroc.apply_undistort(img_r, map1)))
    return pairs, imu


def test_j_inputs_match_jax():
    """J: the rig (its rotation through each package's float32 `exp_so3`),
    the KB8 rectification (both maps, `new_k4`, the baseline, `R1`), the
    three configurations (the rectified pinhole, `stereo_bf`, `Tbc` with
    `R1`), the first three rectified pairs and the IMU samples of frames 0-2
    (none, then 20 each) bit-equal to the JAX test's."""
    jcfgs, jrect = _jax_j_setup()
    R, t = acc.j_rig()
    Rj, tj = fsi.rig()
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    rect = acc.j_rectification()
    for a, b in zip(rect, jrect):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(rect[3], fsi.BASELINE, rtol=1e-6)
    for a, b in zip(acc.j_configs(rect), jcfgs):
        assert H.jax_config(a) == b, (a, b)
    pairs, imu = _jax_j_inputs(3, jrect)
    for (a, b), (c, d) in zip(acc.j_pairs(range(3), rect), pairs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    _same_imu([acc.j_imu(i) for i in range(3)], imu)
    assert [len(r) for r in imu] == [0, 20, 20]


def test_j_stereo_init_and_first_tracked_frames_match_jax():
    """J's first three frames through the JAX and the port's
    `StereoInertialSystem` at J's configuration.  The port's extraction of
    the first pair matches JAX's (`_extraction_matches_jax`; measured on
    frames 0-2: the same 800 keypoints, at most one keypoint in another
    bin and one bit off per image, angles within 0.0055 degrees); then
    JAX's features of each image are handed to both Systems with the
    rectified images (the refinement reads them).  Frame 0, the stereo
    initialization: the rectified pair's depths (validity equal, depths
    within 1e-4 relative) and the map and feature bank made from them
    (integer fields equal, floats within 1e-4, scale ranges within 1e-4
    relative), OK at the origin.  Frames 1 and 2, the first tracked frames
    (before the IMU initializes), from JAX's state after frame 0 given to
    the port (`inertial_snapshot`, the keyframe database): poses within
    1e-4, the same inliers.  From its own map (points within float32
    rounding of JAX's) the port keeps one inlier fewer than JAX at frame 1
    (`tests/acceptance_numbers.py floats`): every predicted scale level of
    that frame is taken at an integer
    (`test_j_card_check_skips_the_tracked_frame_at_the_init_pose`), and the
    rounding of the triangulated depth decides one of them; no logic
    differs."""
    jcfgs, jrect = _jax_j_setup()
    pairs, imu = _jax_j_inputs(3, jrect)
    tcfgs = acc.j_configs()
    for img in pairs[0]:
        _extraction_matches_jax(img, tcfgs[0].orb, min_valid=780)
    jsys = jsis.StereoInertialSystem(*jcfgs)
    tsys = tsis.StereoInertialSystem(*tcfgs, device="cpu")
    feats = [[jx.extract_jit(jnp.asarray(img), jcfgs[0].orb) for img in pr] for pr in pairs]

    def feed(s, i):
        for sample in imu[i]:
            s.grab_imu(*sample)
        (fl, fr), (il, ir) = feats[i], pairs[i]
        if isinstance(s, tsystem.System):
            s.track_stereo(il, ir, ts=i / fsi.FPS,
                           features_l=convert.frame_from_numpy(H.fields(fl)),
                           features_r=convert.frame_from_numpy(H.fields(fr)))
        else:
            s.track_stereo(jnp.asarray(il), jnp.asarray(ir), ts=i / fsi.FPS,
                           features_l=fl, features_r=fr)

    feed(jsys, 0)
    feed(tsys, 0)
    assert jsys.state == tsys.state == jsystem.OK
    np.testing.assert_array_equal(tsys._depth.valid.numpy(), _np(jsys._depth.valid))
    np.testing.assert_allclose(tsys._depth.depth.numpy(), _np(jsys._depth.depth),
                               rtol=1e-4, atol=0)
    g, r = convert.to_numpy(tsys.map), H.fields(jsys.map)
    _fields_close(g, r, atol=1e-4, skip=("pt_min_dist", "pt_max_dist"))
    for name in ("pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(g[name], r[name], rtol=1e-4, err_msg=name)
    _fields_close(convert.to_numpy(tsys.bank), H.fields(jsys.bank), atol=1e-4)
    assert int(tsys.map.n_pt) == int(jsys.map.n_pt) > 300
    np.testing.assert_allclose(tsys.t_cur.numpy(), np.zeros(3), atol=0)
    H.load_inertial_snapshot(H.inertial_snapshot(jsys), tsys)
    H.copy_keyframe_db(jsys, tsys)
    _tracks_alike(jsys, tsys, feed, 1)
    assert not tsys.imu_initialized and not jsys.imu_initialized


# ------------------------------------------------------------- whole scenarios
@pytest.mark.slow
@pytest.mark.parametrize("which", list("ABCDEFGHIJ"))
def test_whole_scenario_holds_the_jax_gates(which):
    """The whole scenario on the port on the CPU, under the JAX test's gates
    (`acceptance.run_<which>`'s `bad` lists every gate it missed).

    The JAX test's own numbers, from one run of each JAX test's drive on the
    CPU (JAX 0.9.0; `python tests/acceptance_numbers.py jax A ... I`), beside
    the port's on the same inputs on the CPU (torch 2.13.0, 2 threads;
    `... port A ... I`):
      A: 31/36 OK, 0 resets, ATE 0.011771 of a span 1.2291 (0.0096), 7
         keyframes, initialized at frame 5.  Port: 31, 0, 0.011765, 7, 5.
      B: 24/36 OK (gate 22), 0 resets, ATE 0.025583 of 1.0194 (0.0251), 6
         keyframes, initialized at frame 12.  Port: 24, 0, 0.025582, 6, 12.
      C: repeatability 0.78784, recall 0.46789, precision 0.90538.  Port: equal.
      D: scores (4.2496, 3.6991, 8.8254, 4.2345)e-4, place 2 first by 2.0767x.
         Port: the same to 2e-7 relative, 2.0767x.
      E: scores (3.4978, 2.4690, 6.8740, 3.7025)e-4, 1.8566x.  Port: 1.8566x.
      F: 0 resets, the IMU initialized at frame 33, over the second half scale
         1.02237 and RMSE 0.017289, 22 keyframes.  Port: 0, 33, 1.01700,
         0.015429, 22.
      G: 0 resets, OK, the IMU at frame 27, rigid RMSE 0.0038343, scale
         0.99631, 18 keyframes.  Port: 0, OK, 0.0037343, 0.99641, 18.
      H: 0 resets, OK, ATE 0.016160 (scale 5.558), 47 keyframes, 0 loops
         closed (none needed at this drift).  Port: 0, OK, 0.016174, 47, 0
         loops.
      I: OK, 0 resets, 59 poses of 60, ATE 0.0038570, 10 keyframes, 1018
         points.  Port: OK, 0, 59, 0.0038166, 10, 1016.
    """
    r = acc.SCENARIOS[which]("cpu")
    assert not r["bad"], (r["bad"], r["gates"])
    if which in "ABFGHI":
        assert r["n_resets"] == 0
