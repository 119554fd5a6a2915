"""The ORB patch kernels (CUDA, sm_90a) against their plain PyTorch twins, the
keyframe step on the card against the same step on the CPU, the `System`
from raw frames on the card, the 65536-word vocabulary and a relocalization
on the card.

These need an NVIDIA GPU with nvcc and are marked `gpu`; without a card they
skip.  With a GPU: `python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest`
(`tests/conftest.py` imports JAX, which a GPU machine for the port need not have).
"""

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.features import extractor
from orbslam3_tpu_torch.features.extractor import OrbParams
from orbslam3_tpu_torch.ops import brief, orb_patches, orient
from orbslam3_tpu_torch.pipeline import system
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.utils import seeded_scene as ss

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _atlas(rng, h, w, integer):
    a = rng.uniform(0, 255, (h, w)).astype(np.float32)
    return np.round(a) if integer else a


def _keypoints(rng, h, w, n):
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    xy[: n // 4, 0] = rng.integers(0, 16, n // 4)          # clamped windows
    xy[n // 4: n // 2, 1] = rng.integers(h - 16, h, n // 4)
    return xy.astype(np.float32)


@pytest.mark.parametrize("integer", [True, False])
def test_ic_moments_kernel_matches_twin(dev, integer):
    """Integer pixels: bit-equal (every partial sum is exact).  Otherwise
    within 1e-5 * sum(|w| * I): the kernel sums in another order."""
    rng = np.random.default_rng(0)
    h, w = 300, 500
    img = torch.from_numpy(_atlas(rng, h, w, integer)).to(dev)
    xy = torch.from_numpy(_keypoints(rng, h, w, 1000)).to(dev)
    got = orb_patches.ic_moments(img, xy)
    ref = orient.ic_moments(img, xy)
    torch.cuda.synchronize()
    if integer:
        assert torch.equal(got, ref)
    else:
        wu, wv = orient._moment_weights()
        absw = torch.from_numpy(np.abs(np.stack([wu, wv], -1))).to(dev)
        mass = torch.einsum("nij,ijc->nc",
                            orient.extract_patches(img, xy.to(torch.int32),
                                                    orient.HALF_PATCH_SIZE), absw)
        assert bool(((got - ref).abs() <= 1e-5 * mass).all())


def test_brief_kernel_matches_twin(dev):
    """Integer pixels and the same angles: bit-identical descriptors, for
    every angle bin and across the bin boundaries."""
    rng = np.random.default_rng(1)
    h, w = 300, 500
    img = torch.from_numpy(_atlas(rng, h, w, True)).to(dev)
    xy = torch.from_numpy(_keypoints(rng, h, w, 1024)).to(dev)
    ang = np.r_[np.arange(32) * 11.25, np.arange(32) * 11.25 + 5.625,
                rng.uniform(0, 360, 960)].astype(np.float32)
    ang = torch.from_numpy(ang).to(dev)
    got = orb_patches.brief_descriptors(img, xy, ang)
    ref = brief.compute_descriptors(img, xy, ang)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("integer", [True, False])
def test_orb_describe_kernel_matches_plain(dev, integer):
    """The one-launch kernel against its plain version on the card: moments
    bit-equal to `ic_moments`' (the same sums in the same order); on
    integer pixels the angles bit-equal to the twin's (the moments are exact
    and the angle is the same three operations), otherwise within the angle
    that the moments' tolerance of 1e-5 * sum(|w| * I) allows; descriptors
    bit-identical to the twin's at the kernel's own angles."""
    rng = np.random.default_rng(3)
    h, w = 300, 500
    raw = torch.from_numpy(_atlas(rng, h, w, integer)).to(dev)
    blur = torch.from_numpy(_atlas(rng, h, w, True)).to(dev)
    xy = torch.from_numpy(_keypoints(rng, h, w, 1000)).to(dev)
    angle, desc, mom = orb_patches.orb_describe(raw, blur, xy, with_moments=True)
    mom_k1 = orb_patches.ic_moments(raw, xy)
    angle_p, _ = orb_patches.describe_plain(raw, blur, xy)
    torch.cuda.synchronize()
    assert torch.equal(mom, mom_k1)
    if integer:
        assert torch.equal(angle, angle_p)
    else:
        mom_p = orient.ic_moments(raw, xy)
        wu, wv = orient._moment_weights()
        absw = torch.from_numpy(np.abs(np.stack([wu, wv], -1))).to(dev)
        mass = torch.einsum("nij,ijc->nc",
                            orient.extract_patches(raw, xy.to(torch.int32),
                                                    orient.HALF_PATCH_SIZE), absw)
        # |d angle| <= |d mom| / |mom| radians, and one float32 step of 360
        tol = torch.rad2deg(1e-5 * torch.linalg.norm(mass, dim=1)
                            / torch.linalg.norm(mom_p, dim=1)) + 1e-4
        d = (angle - angle_p).abs()
        assert bool((torch.minimum(d, 360.0 - d) <= tol).all())
    assert bool(((angle >= 0) & (angle <= 360)).all())
    assert torch.equal(desc, brief.compute_descriptors(blur, xy, angle))


def test_extract_launches_each_kernel_once(dev):
    """`extract` on a CUDA tensor: one launch of the one-launch kernel and
    none of the two on their own."""
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.integers(0, 256, (240, 376)).astype(np.uint8)).to(dev)
    p = extractor.OrbParams(n_features=500, n_levels=4)
    orb_patches.reset_counters()
    ff = extractor.extract(img, p)
    torch.cuda.synchronize()
    assert orb_patches.launch_counts() == {
        "ic_moments": 0, "brief_desc": 0, "orb_describe": 1}
    ref = extractor.extract(img.cpu(), p)
    lv0 = ref.octave == 0
    assert torch.equal(ff.xy.cpu()[lv0], ref.xy[lv0])


def test_kernel_wrappers_refuse_bad_inputs(dev):
    img = torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError):
        orb_patches.ic_moments(img, torch.zeros(4, 2))                 # xy on the CPU
    with pytest.raises(ValueError):
        orb_patches.ic_moments(img.double(), torch.zeros(4, 2, device=dev))
    with pytest.raises(ValueError):
        orb_patches.brief_descriptors(torch.zeros(20, 20, device=dev),
                                      torch.zeros(4, 2, device=dev),
                                      torch.zeros(4, device=dev))     # smaller than 39
    with pytest.raises(ValueError):
        orb_patches.orb_describe(img, torch.zeros(64, 65, device=dev),
                                 torch.zeros(4, 2, device=dev))       # atlases differ


def test_kf_step_on_the_card_matches_the_cpu(dev):
    """The first keyframe step of the seeded drive (small size) on CUDA
    tensors and on a CPU copy of the same inputs: the same new points from
    the same keypoints in the same slots (up to near-tied points swapping
    slots, see `kf_step_mismatch`) and the same bindings, poses within 1e-4
    and points within 5e-3 relative.  The float32 sums run in another order
    on the card; the new points of this small scene are triangulated under
    a few degrees of parallax, so their depth is ill-conditioned and that
    noise grows along the viewing ray through the six LM steps (measured
    on an H100: 1.5e-3 at most)."""
    cfg = ss.SceneConfig(hw=(240, 376), K4=(400.0, 400.0, 188.0, 120.0),
                         orb=OrbParams(n_features=500, n_levels=4),
                         capacity=MapCapacity(n_kf=16, n_pt=4096, n_obs=16384),
                         view_points=2048, ba_caps=(8, 1024, 4096), new_pt_budget=256)
    frames = ss.render_frames(cfg)
    m, bank, view = ss.seed_map(cfg, frames, dev)
    m, ff, kp_pt, R, t, fi = ss.first_kf_inputs(cfg, m, view, frames, dev)
    ki = len(cfg.seed_frames)
    scfg = ss.slam_config(cfg)

    def step(device):
        mv = lambda x: x.to(device)
        cast = lambda tup: type(tup)(*(mv(x) for x in tup))
        kp_ur = torch.full((ff.xy.shape[0],), -1.0, device=device)
        return system.kf_step(scfg, torch.tensor(cfg.K4, device=device), cast(m),
                              cast(bank), cast(ff), mv(kp_pt), mv(R), mv(t),
                              fi / 10.0, fi, kp_ur, ki)

    on_card = step(dev)
    torch.cuda.synchronize()
    assert on_card[0].kf_R.device.type == "cuda"
    bad, _ = ss.kf_step_mismatch(step("cpu"), on_card, kp_pt, pt_rel_tol=5e-3)
    assert bad == []
    assert int(on_card[4]) > 0


def test_system_boots_from_raw_frames_on_the_card(dev):
    """The smoke run's system phase at a small size: 60 rendered frames
    through `System.track_monocular` alone, the `System` built with no device
    argument.  The small image sees less of the plane, so initialization
    takes until about frame 30; the other gates are the smoke run's."""
    cfg = ss.SceneConfig(hw=(240, 376), K4=(400.0, 400.0, 188.0, 120.0),
                         orb=OrbParams(n_features=500, n_levels=4),
                         capacity=MapCapacity(n_kf=16, n_pt=4096, n_obs=16384),
                         seed_frames=(), track_frames=tuple(range(60)),
                         view_points=2048, ba_caps=(8, 1024, 4096), new_pt_budget=256)
    orb_patches.reset_counters()
    sys_, drive = ss.drive_system(cfg, ss.render_frames(cfg), None)
    bad, stats = ss.check_system_gates(sys_, drive, init_by=40)
    assert bad == []
    assert stats["init"]["used_homography"]
    assert sys_.device == dev
    assert sys_.map.pt_xyz.device == dev and sys_.bank.xy.device == dev
    assert sys_.view.xyz.device == dev
    assert orb_patches.launch_counts() == {
        "ic_moments": 0, "brief_desc": 0, "orb_describe": 60}


def test_assign_words_at_65536_words_on_the_card(dev):
    """The default vocabulary on the card: the words of 1200 descriptors
    (anchors with a few bits flipped, and random ones) identical to the
    CPU's, where every distance is an exact integer too, and identical to a
    chunked evaluation through `brief.hamming_distance`."""
    from orbslam3_tpu_torch.place import vocab
    rng = np.random.default_rng(5)
    cb = vocab.load_codebook(65536)
    d = cb[rng.integers(0, 65536, 1200)].copy()
    d[np.arange(1200), rng.integers(0, 8, 1200)] ^= np.uint32(1) << rng.integers(0, 32, 1200).astype(np.uint32)
    d[600:] = rng.integers(0, 2 ** 32, (600, 8), dtype=np.uint32)
    desc = torch.from_numpy(d.view(np.int32))
    on_cpu = vocab.assign_words(desc, vocab.codebook_tensor(cb))
    cb_dev = vocab.codebook_tensor(cb, dev)
    on_card = vocab.assign_words(desc.to(dev), vocab.unpack_codebook(cb_dev))
    torch.cuda.synchronize()
    assert on_card.device == dev and torch.equal(on_card.cpu(), on_cpu)
    chunked = vocab.assign_words_chunked(desc.to(dev), cb_dev, chunk=500)
    assert torch.equal(chunked, on_card)
    dist = brief.hamming_distance(desc.to(dev)[:64], cb_dev)
    assert torch.equal(torch.argmin(dist, dim=1).to(torch.int32), on_card[:64])


def test_system_relocalizes_on_the_card(dev):
    """The smoke run's relocalization phase at a small size: the `System`
    boots from 60 rendered frames on the card, loses its track on 3
    textureless frames and recovers on a frame from early on the path through
    the keyframe database and the batched MLPnP, with no reset."""
    cfg = ss.SceneConfig(hw=(240, 376), K4=(400.0, 400.0, 188.0, 120.0),
                         orb=OrbParams(n_features=500, n_levels=4),
                         capacity=MapCapacity(n_kf=16, n_pt=4096, n_obs=16384),
                         seed_frames=(), track_frames=tuple(range(60)),
                         view_points=2048, ba_caps=(8, 1024, 4096), new_pt_budget=256)
    sys_, drive = ss.drive_system(cfg, ss.render_frames(cfg), None)
    bad, stats = ss.check_system_gates(sys_, drive, init_by=40)
    assert bad == []
    lc = sys_.loop_closer
    assert lc.db.tf.device == dev and lc.codebook.device == dev
    assert torch.equal(lc.db.active, sys_.map.kf_valid)
    f0 = stats["init_frame"]
    d = ss.drive_relocalization(sys_, cfg, tuple(range(f0 + 3, f0 + 9)), None)
    assert ss.check_reloc_gates(sys_, d, 0) == []
    assert sys_.R_cur.device == dev
