"""Parity of the port's ORB front-end (orbslam3_tpu_torch) with the JAX package.

Inputs are made with numpy from a seed and fed to both sides.  The JAX side
runs on the CPU as the JAX tests run it: the plain path, and for the two
Pallas kernels `pallas_patches.extract_moments_and_patches(...,
interpret=True)`.  Each tolerance is stated where it is used, with its reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.ops import brief as jbrief
from orbslam3_tpu.ops import fast as jfast
from orbslam3_tpu.ops import gridselect as jgrid
from orbslam3_tpu.ops import image as jimage
from orbslam3_tpu.ops import orient as jorient
from orbslam3_tpu.ops import pallas_patches
from orbslam3_tpu.utils import synth_render as jsr
from orbslam3_tpu_torch.features import extractor as tx
from orbslam3_tpu_torch.ops import brief as tbrief
from orbslam3_tpu_torch.ops import fast as tfast
from orbslam3_tpu_torch.ops import gridselect as tgrid
from orbslam3_tpu_torch.ops import image as timage
from orbslam3_tpu_torch.ops import orb_patches
from orbslam3_tpu_torch.ops import orient as torient
from orbslam3_tpu_torch.utils import synth_render as tsr

torch.set_num_threads(2)

K_SMALL = (100.0, 100.0, 94.0, 60.0)
HW_SMALL = (120, 188)


def _t(a):
    return torch.from_numpy(np.array(a))


def _textured(hw=HW_SMALL, K4=K_SMALL, x=0.0, seed=0):
    tex = tsr.block_texture(np.random.default_rng(3), block=10)
    R, t = tsr.look_down_pose(x, 0.0, 5.0, yaw=0.1)
    img = tsr.render_plane(R, t, np.asarray(K4), hw, tex, tex_scale=60.0)
    noise = np.random.default_rng(seed).normal(0, 1.5, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


# --------------------------------------------------------------- image ops
@pytest.mark.parametrize("n_in,n_out", [(480, 400), (752, 627), (120, 100),
                                        (188, 157), (83, 69), (50, 50)])
def test_resize_matrix_matches_jax(n_in, n_out):
    """The operator JAX applies along one axis is resize(eye): scale 1 on
    the other axis is skipped and multiplying by 0/1 is exact.  Tolerance
    1e-5: the same float32 steps (the fused sample position included), but
    XLA may divide and sum each column's weights in another order than
    numpy (measured: at most 3.2e-6, on 83 -> 69)."""
    ref = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32),
                                      (n_out, n_in), method="linear"))
    np.testing.assert_allclose(timage._resize_matrix_np(n_in, n_out), ref,
                               rtol=0, atol=1e-5)


def test_resize_and_pyramid_match_jax():
    """Pyramid levels agree to 1e-3 graylevels (float32 matmul order differs
    from XLA's einsum); blurred levels are rounded to integers and must be
    equal except where JAX's unrounded blur lies within 1e-3 of a .5 tie."""
    img = np.random.default_rng(1).integers(0, 256, (96, 150)).astype(np.float32)
    jp, jb = jimage.build_pyramid(jnp.asarray(img), 4, 1.2)
    tp, tb = timage.build_pyramid(_t(img), 4, 1.2)
    for lv in range(4):
        np.testing.assert_allclose(tp[lv].numpy(), np.asarray(jp[lv]), atol=1e-3)
        raw = np.asarray(jimage.gaussian_blur(jp[lv]))
        tie = np.abs(raw - np.floor(raw) - 0.5) < 1e-3
        same = tb[lv].numpy() == np.asarray(jb[lv])
        assert np.all(same | tie), lv
    assert timage.pyramid_shapes(480, 752, 8, 1.2) == jimage.pyramid_shapes(480, 752, 8, 1.2)


# ---------------------------------------------------------------- FAST
def test_fast_score_nms_detect_exact():
    """Integer images: every score is an integer, so both sides are exact."""
    img = _textured().astype(np.float32)
    np.testing.assert_array_equal(tfast.fast_score(_t(img), 3).numpy(),
                                  np.asarray(jfast.fast_score(jnp.asarray(img), 3)))
    s = np.asarray(jfast.fast_score(jnp.asarray(img), 19))
    np.testing.assert_array_equal(tfast.nms3x3(_t(s)).numpy(),
                                  np.asarray(jfast.nms3x3(jnp.asarray(s))))
    np.testing.assert_array_equal(tfast.detect(_t(img), 7.0, 19).numpy(),
                                  np.asarray(jfast.detect(jnp.asarray(img), 7.0, 19)))


@pytest.mark.parametrize("seed", [0, 1])
def test_select_uniform_exact_with_ties(seed):
    """Integer responses in a narrow range tie within cells; the stable
    sorts must pick exactly the JAX indices."""
    rng = np.random.default_rng(seed)
    m = 600
    xy = np.stack([rng.integers(0, 188, m), rng.integers(0, 120, m)], 1).astype(np.float32)
    resp = rng.integers(7, 12, m).astype(np.float32)
    valid = rng.random(m) < 0.8
    ref = np.asarray(jgrid.select_uniform(jnp.asarray(xy), jnp.asarray(resp),
                                          jnp.asarray(valid), (120, 188), (6, 9), 150))
    got = tgrid.select_uniform(_t(xy), _t(resp), _t(valid), (120, 188), (6, 9), 150)
    np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------ orientation + BRIEF
def test_orient_and_brief_twins_match_jax_plain_path():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (90, 130)).astype(np.float32)
    xy = np.stack([rng.integers(0, 130, 80), rng.integers(0, 90, 80)], 1).astype(np.float32)
    ang_j = np.asarray(jorient.ic_angle(jnp.asarray(img), jnp.asarray(xy)))
    ang_t = torient.ic_angle(_t(img), _t(xy)).numpy()
    # integer pixels: moments exact; atan2 may differ by an ulp
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-4)
    desc_j = np.asarray(jbrief.compute_descriptors(jnp.asarray(img), jnp.asarray(xy),
                                                   jnp.asarray(ang_j)))
    desc_t = tbrief.compute_descriptors(_t(img), _t(xy), _t(ang_j)).numpy()
    np.testing.assert_array_equal(desc_t.view(np.uint32), desc_j)
    np.testing.assert_array_equal(torient._umax_table(), jorient._umax_table())
    np.testing.assert_array_equal(tbrief._binned_offsets(), jbrief._binned_offsets())


def test_unpack_and_hamming_match_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (30, 8), dtype=np.uint64).astype(np.uint32)
    ta, tb = _t(a.view(np.int32)), _t(b.view(np.int32))
    np.testing.assert_array_equal(tbrief.unpack_bits(ta).numpy(),
                                  np.asarray(jbrief.unpack_bits(jnp.asarray(a))))
    np.testing.assert_array_equal(tbrief.hamming_distance(ta, tb).numpy(),
                                  np.asarray(jbrief.hamming_distance(jnp.asarray(a),
                                                                     jnp.asarray(b))))
    bits = tbrief.unpack_bits(ta) > 0
    np.testing.assert_array_equal(tbrief.pack_bits(bits).numpy(), a.view(np.int32))


def _edge_keypoints(rng, h, w, n):
    """Keypoints anywhere in the atlas, a third of them within 20 px of an
    edge so that the window clamps engage."""
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    k = n // 3
    xy[:k, 0] = rng.choice(np.r_[0:20, w - 20:w], k)
    xy[k:2 * k, 1] = rng.choice(np.r_[0:20, h - 20:h], k)
    return xy.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_twins_match_pallas_interpret(seed):
    """K1's twin gives the Pallas kernel's moments bit for bit (integer
    pixels: exact sums); K2's twin gives the Pallas patches' descriptors
    bit for bit, fed the same angles."""
    rng = np.random.default_rng(seed)
    h, w = 120, 200
    raw = rng.integers(0, 256, (h, w)).astype(np.float32)
    blur = np.round(np.asarray(jimage.gaussian_blur(jnp.asarray(raw))))
    xy = _edge_keypoints(rng, h, w, 70)
    mom_j, pat_j = pallas_patches.extract_moments_and_patches(
        jnp.asarray(raw), jnp.asarray(blur), jnp.asarray(xy), interpret=True)
    ang_j, _ = pallas_patches.ic_angle_and_patches(
        jnp.asarray(raw), jnp.asarray(blur), jnp.asarray(xy), interpret=True)
    desc_j = np.asarray(jbrief.descriptors_from_patches(pat_j, ang_j))

    mom_t = orb_patches.ic_moments(_t(raw), _t(xy))       # CPU -> the twin
    np.testing.assert_array_equal(mom_t.numpy(), np.asarray(mom_j))
    ang_t, desc_t = orb_patches.ic_angle_and_descriptors(_t(raw), _t(blur), _t(xy))
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=1e-4)
    np.testing.assert_array_equal(
        tbrief.angle_bins(ang_t).numpy(),
        np.round(np.asarray(ang_j) * 32 / 360).astype(np.int64) % 32)
    same_angle = orb_patches.brief_descriptors(_t(blur), _t(xy), _t(np.asarray(ang_j)))
    np.testing.assert_array_equal(same_angle.numpy().view(np.uint32), desc_j)
    np.testing.assert_array_equal(desc_t.numpy().view(np.uint32), desc_j)


def test_wrappers_use_twins_on_cpu_and_refuse_other_devices():
    """A CPU tensor runs the twin and launches nothing; a tensor on a device
    the kernels do not serve raises instead of falling back."""
    orb_patches.reset_counters()
    img = torch.zeros(64, 64)
    xy = torch.full((5, 2), 30.0)
    orb_patches.ic_angle_and_descriptors(img, img, xy)
    assert (orb_patches.ic_moments_launches, orb_patches.brief_desc_launches) == (0, 0)
    meta = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError):
        orb_patches.ic_moments(meta, torch.empty(5, 2, device="meta"))
    with pytest.raises(ValueError):
        orb_patches.brief_descriptors(meta, torch.empty(5, 2, device="meta"),
                                      torch.empty(5, device="meta"))


def test_kernel_source_keeps_the_twins_constants():
    """The CUDA source hardcodes the window radii and the word count; they
    must be the twins' (the kernel itself runs only on the card)."""
    src = orb_patches.SOURCE.read_text()
    assert f"kMomHalf = {torient.HALF_PATCH_SIZE};" in src
    assert f"kBriefHalf = {tbrief._PATCH_R};" in src
    assert "kBriefPairs = 256;" in src
    assert "sm_90a" in " ".join(orb_patches.NVCC_FLAGS)


_PRESETS = ("euroc_mono", "euroc_mono_inertial", "euroc_stereo", "euroc_stereo_rectified",
            "euroc_stereo_inertial", "euroc_rgbd", "tumvi_mono", "tumvi_mono_inertial",
            "tumvi_stereo_inertial")


def test_orb_describe_launch_geometry_fits_every_preset():
    """`orb_describe`'s persistent grid (the kernel runs only on the card;
    its geometry is computed here): for every preset's atlas width and every
    keypoint count up to the largest preset's, on an H100 (132 SMs) and on
    smaller cards, at most one block per SM, at most WARPS_MAX warps a block,
    every keypoint covered, one round while N <= WARPS_MAX x #SMs, and the
    dynamic shared memory within a Hopper block's 232,448 bytes.  The
    layout's numbers are the CUDA source's."""
    from orbslam3_tpu_torch import config
    cfgs = [getattr(config, name)() for name in _PRESETS]
    cfgs = [c[0] if isinstance(c, tuple) else c for c in cfgs]
    widths = {c.image_hw[1] for c in cfgs} | {188, 376, 500, 512, 752}
    n_max = max(sum(c.orb.features_per_level()) for c in cfgs)
    assert n_max == 1200 and widths >= {512, 752}
    for n_sm in (132, 114, 78):
        for n in range(1, n_max + 1):
            blocks, warps, smem = orb_patches.launch_geometry(n, n_sm)
            assert 1 <= blocks <= n_sm and 1 <= warps <= orb_patches.WARPS_MAX
            assert smem == orb_patches.TABLE_BYTES + warps * orb_patches.SLOT_BYTES
            assert smem <= orb_patches.SMEM_LIMIT
            assert blocks * warps >= min(n, orb_patches.WARPS_MAX * n_sm)
            assert (blocks - 1) * warps < n                  # no block without work
    assert orb_patches.launch_geometry(1200, 132) == (120, 10, 146_112)
    assert orb_patches.launch_geometry(5000, 132)[:2] == (132, 10)
    with pytest.raises(ValueError):
        orb_patches.launch_geometry(0, 132)
    src = orb_patches.SOURCE.read_text()
    assert f"kMaxWarps = {orb_patches.WARPS_MAX};" in src
    assert "kRawChunks = 9;" in src and "kBlurChunks = 11;" in src
    assert orb_patches.SLOT_BYTES == (torient.HALF_PATCH_SIZE * 2 + 1) * 36 * 4 + 39 * 44 * 4
    # the staged blurred rows reach every rotated pattern point
    assert f"kBriefReach = {orb_patches.BRIEF_REACH};" in src
    assert np.abs(tbrief._binned_offsets()).max() <= orb_patches.BRIEF_REACH
    table = orb_patches._table_bytes()
    assert table.size == orb_patches.TABLE_BYTES
    np.testing.assert_array_equal(table[-64:].view(np.int32), torient._umax_table())


# ------------------------------------------------------------------ extract
def test_extract_small_matches_jax():
    """120x188, 300 features over 4 levels.  Level 0 (integer pixels):
    keypoints, octaves, validity and descriptors bit-identical.  Levels 1-3
    see the resize through a differently ordered float32 matmul; their
    keypoint sets must overlap by at least 95% (measured: 100%)."""
    img = _textured()
    pj = jx.OrbParams(n_features=300, n_levels=4)
    pt = tx.OrbParams(n_features=300, n_levels=4)
    fj = jax.device_get(jx.extract_jit(jnp.asarray(img), pj))
    ft = tx.extract(_t(img), pt)
    assert ft.xy.shape == fj.xy.shape and ft.desc.dtype == torch.int32
    lv0 = fj.octave == 0
    np.testing.assert_array_equal(ft.octave.numpy(), fj.octave)
    np.testing.assert_array_equal(ft.xy.numpy()[lv0], fj.xy[lv0])
    np.testing.assert_array_equal(ft.valid.numpy()[lv0], fj.valid[lv0])
    np.testing.assert_array_equal(ft.desc.numpy()[lv0].view(np.uint32), fj.desc[lv0])
    for lv in range(1, 4):
        m = fj.octave == lv
        sj = set(map(tuple, fj.xy[m][fj.valid[m]].tolist()))
        st = set(map(tuple, ft.xy.numpy()[m][ft.valid.numpy()[m]].tolist()))
        assert len(sj & st) >= 0.95 * max(len(sj), len(st)), lv


def test_synth_render_copy_matches_jax_package():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(tsr.block_texture(rng_a, 256, 8),
                                  jsr.block_texture(rng_b, 256, 8))
    tex = tsr.block_texture(np.random.default_rng(3), block=10)
    R, t = tsr.look_down_pose(0.3, 0.1, 5.0, yaw=0.05, tilt=0.02)
    Rj, tj = jsr.look_down_pose(0.3, 0.1, 5.0, yaw=0.05, tilt=0.02)
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(
        tsr.render_plane(R, t, np.asarray(K_SMALL), HW_SMALL, tex, 60.0),
        jsr.render_plane(Rj, tj, np.asarray(K_SMALL), HW_SMALL, tex, 60.0, mesas=()))
