"""The ORB patch kernels (CUDA, sm_90a) against their plain PyTorch twins and
`orb_describe` against its warp design at every size and atlas width, the
keyframe step on the card against the same step on the CPU, the `System`
from raw frames on the card, the 65536-word vocabulary and a relocalization
on the card, the VI BA, the COO BA and the post-loop GBA, a loop closure, a
map merge and the GNSS BA on the card against the CPU; a stereo pair through
`track_stereo` on the card against the CPU, `orb_describe`'s launches per
stereo frame, `fisheye_stereo_match` on the card against the CPU, the
sequence runner's mono arm on the card, the extraction bench on the card
against the CPU's extraction, the recall curve's rows on the card against
the CPU's from the same descriptors, the sharded BA on the card against the
CPU in each comm mode, the System with its window BA sharded over 8
shards of the card, the bench's chains (`orbslam3_tpu_torch.bench`) at
cut sizes on the card against the CPU, a System's RANSAC draws on the
card equal to the CPU's, and acceptance scenario J (TUM-VI's rectified
fisheye stereo-inertial configuration): its first two tracked frames on the card
against a CPU copy, and `orb_describe` on one of its rectified atlases
against the plain version.

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
    assert orb_patches.launch_counts() == orb_patches.path_counts(1)
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
    for describe in (orb_patches.orb_describe, orb_patches.orb_describe_warp):
        with pytest.raises(ValueError):
            describe(img, img, torch.zeros(4, 2))                     # xy on the CPU
        with pytest.raises(ValueError):
            describe(img, img.t(), torch.zeros(4, 2, device=dev))     # not contiguous
        with pytest.raises(ValueError):
            describe(img, img.double(), torch.zeros(4, 2, device=dev))
        with pytest.raises(ValueError):
            describe(img, img, torch.zeros(0, 2, device=dev))         # no keypoints
        with pytest.raises(ValueError):
            describe(torch.zeros(38, 64, device=dev), torch.zeros(38, 64, device=dev),
                     torch.zeros(4, 2, device=dev))                   # lower than 39


def _edge_keypoints(rng, h, w, n):
    """n keypoints, a quarter of them each within 16 px of the left, bottom,
    right and top edge (their windows clamped there), the rest anywhere."""
    xy = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], 1)
    q = np.array_split(np.arange(n), 4)
    xy[q[0], 0] = rng.uniform(0, 16, len(q[0]))
    xy[q[1], 1] = rng.uniform(h - 16, h - 1, len(q[1]))
    xy[q[2], 0] = rng.uniform(w - 16, w - 1, len(q[2]))
    xy[q[3], 1] = rng.uniform(0, 16, len(q[3]))
    return xy.astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 1001, 5000])
@pytest.mark.parametrize("integer", [True, False])
def test_orb_describe_persistent_grid_matches_the_warp_design(dev, n, integer):
    """The Hopper design against the warp design (`orb_describe_warp`) and
    the plain version, at N = 1, N not a multiple of the block's warps (7,
    1001) and N = 5000 (more than one round of the persistent grid on a
    132-SM card), with windows clamped at all four edges: moments, angles and
    descriptors bit-equal to the warp design's (the same arithmetic on the
    same pixels), and test_orb_describe_kernel_matches_plain's assertions."""
    rng = np.random.default_rng(10 + n)
    h, w = 300, 500
    raw = torch.from_numpy(_atlas(rng, h, w, integer)).to(dev)
    blur = torch.from_numpy(_atlas(rng, h, w, True)).to(dev)
    xy = torch.from_numpy(_edge_keypoints(rng, h, w, n)).to(dev)
    orb_patches.reset_counters()
    angle, desc, mom = orb_patches.orb_describe(raw, blur, xy, with_moments=True)
    angle_w, desc_w, mom_w = orb_patches.orb_describe_warp(raw, blur, xy, with_moments=True)
    mom_k1 = orb_patches.ic_moments(raw, xy)
    angle_p, _ = orb_patches.describe_plain(raw, blur, xy)
    torch.cuda.synchronize()
    assert orb_patches.launch_counts() == {"ic_moments": 1, "brief_desc": 0,
                                           "orb_describe_warp": 1, "orb_describe": 1}
    assert torch.equal(mom, mom_w) and torch.equal(angle, angle_w)
    assert torch.equal(desc, desc_w)
    assert torch.equal(mom, mom_k1)
    if integer:
        assert torch.equal(angle, angle_p)
    else:
        wu, wv = orient._moment_weights()
        absw = torch.from_numpy(np.abs(np.stack([wu, wv], -1))).to(dev)
        mass = torch.einsum("nij,ijc->nc",
                            orient.extract_patches(raw, xy.to(torch.int32),
                                                    orient.HALF_PATCH_SIZE), absw)
        tol = torch.rad2deg(1e-5 * torch.linalg.norm(mass, dim=1)
                            / torch.linalg.norm(orient.ic_moments(raw, xy), dim=1)) + 1e-4
        d = (angle - angle_p).abs()
        assert bool((torch.minimum(d, 360.0 - d) <= tol).all())
    assert bool(((angle >= 0) & (angle <= 360)).all())
    assert torch.equal(desc, brief.compute_descriptors(blur, xy, angle))


@pytest.mark.parametrize("hw", [(120, 188), (240, 376), (2210, 752), (512, 512),
                                (300, 500), (64, 65), (41, 39), (300, 501)])
def test_orb_describe_takes_every_atlas_width(dev, hw):
    """Atlas widths of the presets, the drives and these tests (the rows
    16-byte aligned: the kernel's 16-byte copies) and widths that are not a
    multiple of 4 (its 4-byte copies): bit-equal to the warp design."""
    rng = np.random.default_rng(hw[1])
    h, w = hw
    raw = torch.from_numpy(_atlas(rng, h, w, False)).to(dev)
    blur = torch.from_numpy(_atlas(rng, h, w, True)).to(dev)
    xy = torch.from_numpy(_edge_keypoints(rng, h, w, 1200)).to(dev)
    got = orb_patches.orb_describe(raw, blur, xy, with_moments=True)
    ref = orb_patches.orb_describe_warp(raw, blur, xy, with_moments=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_orb_describe_takes_an_atlas_off_16_byte_alignment(dev):
    """Contiguous atlases whose first pixel lies 4 bytes past a 16-byte
    boundary (views into a larger buffer): the kernel's 4-byte copies, the
    warp design's result."""
    rng = np.random.default_rng(4)
    h, w = 300, 500
    buf = torch.empty(2 * h * w + 8, device=dev)
    raw = buf[1:1 + h * w].view(h, w)
    blur = buf[2 + h * w:2 + 2 * h * w].view(h, w)
    raw.copy_(torch.from_numpy(_atlas(rng, h, w, False)))
    blur.copy_(torch.from_numpy(_atlas(rng, h, w, True)))
    assert raw.data_ptr() % 16 and blur.data_ptr() % 16
    xy = torch.from_numpy(_edge_keypoints(rng, h, w, 700)).to(dev)
    got = orb_patches.orb_describe(raw, blur, xy, with_moments=True)
    ref = orb_patches.orb_describe_warp(raw, blur, xy, with_moments=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_empty_kernel_launches(dev):
    """The floor that chip_smoke.py times beside the kernels launches and
    counts nowhere."""
    orb_patches.reset_counters()
    orb_patches.empty_kernel(dev)
    torch.cuda.synchronize()
    assert set(orb_patches.launch_counts().values()) == {0}


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
    assert orb_patches.launch_counts() == orb_patches.path_counts(60)


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


def _vi_problem(dev, K=6, n_pts=120, seed=0):
    """A numpy-made visual-inertial window: keyframes 0.4 s apart on a
    curved path, 200 Hz preintegrations between them (the port's own, on the
    CPU), points in front seen by every keyframe with 0.3 px of noise,
    keyframe 0 fixed, the rest perturbed."""
    from orbslam3_tpu_torch.ops import imu, lie
    from orbslam3_tpu_torch.solver import inertial, vi_ba
    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -9.81])
    pos = lambda t: np.array([2.0 * np.sin(0.3 * t), np.sin(0.5 * t), 0.5 * np.sin(0.7 * t)])
    acc = lambda t: -np.array([2.0 * 0.09 * np.sin(0.3 * t), 0.25 * np.sin(0.5 * t),
                               0.5 * 0.49 * np.sin(0.7 * t)])
    vel = lambda t: np.array([0.6 * np.cos(0.3 * t), 0.5 * np.cos(0.5 * t), 0.35 * np.cos(0.7 * t)])
    w = np.array([0.05, 0.3, 0.1])
    rot = lambda t: lie.exp_so3(torch.tensor(w * t, dtype=torch.float32)).numpy()
    calib = imu.ImuCalib.create(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    pre = []
    for k in range(K - 1):
        ts = k * 0.4 + (np.arange(80) + 0.5) * 0.005
        a = np.stack([rot(t).T @ (acc(t) - g) for t in ts]).astype(np.float32)
        pre.append(imu.preintegrate(torch.from_numpy(a), torch.from_numpy(np.tile(w, (80, 1)).astype(np.float32)),
                                    torch.full((80,), 0.005), torch.ones(80, dtype=torch.bool), calib,
                                    n_valid=80))
    f = inertial.stack_preints_device(pre, list(range(K - 1)), list(range(1, K)))
    Rs = np.stack([rot(0.4 * k) for k in range(K)]).astype(np.float32)
    ps = np.stack([pos(0.4 * k) for k in range(K)]).astype(np.float32)
    vs = np.stack([vel(0.4 * k) for k in range(K)]).astype(np.float32)
    X = np.stack([rng.uniform(-4, 6, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(6, 14, n_pts)],
                 1).astype(np.float32)
    K4 = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    Xb = np.einsum("kji,kpj->kpi", Rs, X[None] - ps[:, None])
    uv = K4[:2] * Xb[..., :2] / Xb[..., 2:] + K4[2:] + rng.normal(0, 0.3, (K, n_pts, 2))
    d = rng.normal(0, 0.01, (K, 15)).astype(np.float32)
    d[0] = 0.0
    d[:, 9:] = 0.0
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    Rp, pp, vp, bp = vi_ba.apply_delta(t(Rs), t(ps), t(vs), torch.zeros(K, 6), t(d))
    prob = vi_ba.VIProblem(
        Rwb=Rp, pwb=pp, vel=vp, bias=bp, cam_fixed=torch.arange(K) == 0,
        cam_valid=torch.ones(K, dtype=torch.bool),
        X=t(X + rng.normal(0, 0.03, X.shape)), pt_valid=torch.ones(n_pts, dtype=torch.bool),
        obs_cam=torch.arange(K).repeat_interleave(n_pts), obs_pt=torch.arange(n_pts).repeat(K),
        obs_uv=t(uv.reshape(-1, 2)), obs_inv_sigma2=torch.ones(K * n_pts),
        obs_valid=torch.ones(K * n_pts, dtype=torch.bool), factors=f,
        gravity=torch.tensor(g, dtype=torch.float32), Rcb=torch.eye(3), tcb=torch.zeros(3))
    mv = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else type(x)(*(mv(y) for y in x))
    return prob, mv(prob), torch.from_numpy(K4)


def test_vi_bundle_adjust_on_the_card_matches_the_cpu(dev):
    """The dense VI window BA (what the inertial System's keyframe step runs)
    and its matrix-free twin on the card against the CPU on the same
    problem: states within 1e-4, points within 1e-3 relative, after 4 LM
    steps; the dense product stays float32 (no TF32)."""
    from orbslam3_tpu_torch.solver import vi_ba
    prob, prob_d, K4 = _vi_problem(dev)
    assert not torch.backends.cuda.matmul.allow_tf32
    for schur in ("dense", "pcg"):
        ref = vi_ba.vi_bundle_adjust(prob, "pinhole", K4, iterations=4, schur=schur)
        got = vi_ba.vi_bundle_adjust(prob_d, "pinhole", K4.to(dev), iterations=4, schur=schur)
        for a, b, name in zip(got[:4], ref[:4], ("Rwb", "pwb", "vel", "bias")):
            assert a.device == dev
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4, err_msg=name)
        rel = (got.X.cpu() - ref.X).abs().max() / ref.X.abs().max()
        assert float(rel) < 1e-3


def _coo_problem(seed=0, K=6, n_pts=150):
    """A COO BA problem made with numpy: K cameras along x (the first two
    fixed), n_pts points, 0.5 px noise, poses and points perturbed."""
    from orbslam3_tpu_torch.ops import lie
    from orbslam3_tpu_torch.solver import ba
    rng = np.random.default_rng(seed)
    K4 = torch.tensor([458.654, 457.296, 367.215, 248.375])
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(5, 9, n_pts)], 1).astype(np.float32)
    R = lie.exp_so3(torch.from_numpy(rng.normal(0, 0.02, (K, 3)).astype(np.float32)))
    t = torch.from_numpy(np.stack([[-0.3 * k, 0.0, 0.0] for k in range(K)]).astype(np.float32))
    Xc = torch.einsum("kij,pj->kpi", R, torch.from_numpy(X)) + t[:, None]
    uv = K4[:2] * Xc[..., :2] / Xc[..., 2:] + K4[2:] + \
        torch.from_numpy(rng.normal(0, 0.5, (K, n_pts, 2)).astype(np.float32))
    dR, dt = lie.se3_exp(torch.from_numpy(rng.normal(0, 0.01, (K, 6)).astype(np.float32)))
    Rp, tp = lie.se3_compose(dR, dt, R, t)
    fixed = torch.arange(K) < 2
    prob = ba.BAProblem(
        R=torch.where(fixed[:, None, None], R, Rp), t=torch.where(fixed[:, None], t, tp),
        cam_fixed=fixed, cam_valid=torch.ones(K, dtype=torch.bool),
        X=torch.from_numpy(X + rng.normal(0, 0.03, X.shape).astype(np.float32)),
        pt_valid=torch.ones(n_pts, dtype=torch.bool),
        obs_cam=torch.arange(K).repeat_interleave(n_pts), obs_pt=torch.arange(n_pts).repeat(K),
        obs_uv=uv.reshape(-1, 2), obs_inv_sigma2=torch.ones(K * n_pts),
        obs_valid=torch.ones(K * n_pts, dtype=torch.bool))
    return prob, K4


def _loop_system(device, cap):
    from orbslam3_tpu_torch.utils import loop_scene
    cfg = system.SlamConfig(cam_params=loop_scene.K4, image_hw=(480, 752),
                            enable_relocalization=False, local_view_points=2048,
                            map_capacity=MapCapacity(**cap))
    sys_ = system.System(cfg, device=device)
    return sys_, loop_scene.build(sys_, n_kp=256)


def test_coo_bundle_adjust_and_gba_on_the_card_match_the_cpu(dev):
    """The COO bundle adjuster (PCG and dense Schur, 4 LM steps) and the
    post-loop `gba` (capacity-wide temporal window from the bank, PCG) at 32
    keyframes / 4096 points / 16384 observations on the loop scene: the card
    against the CPU, poses within 1e-4 and points within 1e-3 relative."""
    from orbslam3_tpu_torch.solver import ba
    prob, K4 = _coo_problem()
    mv = lambda p: type(p)(*(None if x is None else x.to(dev) for x in p))
    for solver in ("pcg", "dense"):
        ref = ba.bundle_adjust(prob, "pinhole", K4, iterations=4, schur_solver=solver)
        got = ba.bundle_adjust(mv(prob), "pinhole", K4.to(dev), iterations=4,
                               schur_solver=solver)
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
        assert float((got.X.cpu() - ref.X).abs().max() / ref.X.abs().max()) < 1e-3
    cap = dict(n_kf=32, n_pt=4096, n_obs=16384)
    cpu, rv = _loop_system("cpu", cap)
    card, _ = _loop_system(dev, cap)
    ref = system.gba(cpu.cfg, cpu.cam_params, cpu.map, rv.kr, cpu.bank)
    got = system.gba(card.cfg, card.cam_params, card.map, rv.kr, card.bank)
    assert got.kf_R.device == dev
    np.testing.assert_allclose(got.kf_t.cpu().numpy(), ref.kf_t.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.kf_R.cpu().numpy(), ref.kf_R.numpy(), atol=1e-4)
    assert float((got.pt_xyz.cpu() - ref.pt_xyz).abs().max() / ref.pt_xyz.abs().max()) < 1e-3


def test_try_close_on_the_card_matches_the_cpu(dev):
    """The drifted revisit closed on the card and on the CPU with the same
    Sim3 samples (`loop_scene.fixed_samples`): the same winner, matches and
    inliers, keyframe poses and points within 1e-3; on the card the
    revisit's centre back within 0.15 of the origin, the GBA posted on the
    side stream and merged by a forced merge, every point finite after it,
    and the merged map held to the same GBA run on the CPU from the inputs
    the side stream read, in what a GBA determines: every observation's
    projection within 0.02 px, points within 1e-4 of the map's extent,
    keyframe 0's and the revisit's poses within 1e-4 (each exploring
    keyframe sees only its own points and is free to move with them:
    measured up to 3e-3 apart).  The CPU copy's own GBA starts from its own
    closure and is held to its gate only."""
    from orbslam3_tpu_torch.utils import loop_scene
    cap = dict(n_kf=32, n_pt=4096, n_obs=16384)
    out = {}
    for device in ("cpu", dev):
        sys_, rv = _loop_system(device, cap)
        lc = loop_scene.loop_closer(sys_, rv.kr)
        assert lc.try_close(sys_, rv.ff, rv.kr, idx_fn=loop_scene.fixed_samples)
        out[str(device)] = (sys_, lc.last_closure)
    (c, cc), (g, gc) = out["cpu"], out[str(dev)]
    assert cc == gc and cc["cand"] == 0
    np.testing.assert_allclose(g.map.kf_R.cpu().numpy(), c.map.kf_R.numpy(), atol=1e-3)
    np.testing.assert_allclose(g.map.kf_t.cpu().numpy(), c.map.kf_t.numpy(), atol=1e-3)
    assert float((g.map.pt_xyz.cpu() - c.map.pt_xyz).abs().max()) < 1e-3
    m = g.map
    kr = 15
    assert float(torch.linalg.norm(-m.kf_R[kr].T @ m.kf_t[kr])) < 0.15
    assert g._pending is not None and g._pending.done is not None
    m_in, bank_in = (type(x)(*(y.cpu() for y in x)) for x in g._pending.inputs)
    g._merge_pending(force=True)
    c._merge_pending(force=True)
    assert g._pending is None and g.chain_counts["merged gba forced"] == 1
    assert c._pending is None and c.chain_counts["merged gba forced"] == 1
    assert bool(torch.isfinite(g.map.pt_xyz).all())
    ref = system.gba(c.cfg, c.cam_params, m_in, kr, bank_in)
    got = type(g.map)(*(x.cpu() for x in g.map))
    assert torch.equal(got.pt_valid, ref.pt_valid)
    (uv_g, meas_g), (uv_r, meas_r) = map(loop_scene.reprojections, (got, ref))
    assert torch.equal(meas_g, meas_r) and float((uv_g - uv_r).abs().max()) < 0.02
    for k in (0, kr):
        np.testing.assert_allclose(got.kf_R[k].numpy(), ref.kf_R[k].numpy(), atol=1e-4)
        np.testing.assert_allclose(got.kf_t[k].numpy(), ref.kf_t[k].numpy(), atol=1e-4)
    ok = ref.pt_valid
    assert float((got.pt_xyz[ok] - ref.pt_xyz[ok]).abs().max()
                 / ref.pt_xyz[ok].abs().max()) < 1e-4
    assert float(torch.linalg.norm(-c.map.kf_R[kr].T @ c.map.kf_t[kr])) < 0.15
    assert float(torch.linalg.norm(-g.map.kf_R[kr].T @ g.map.kf_t[kr])) < 0.15


def _merged(device):
    """`atlas_scene.two_sessions` on `device`, merged by `try_merge` with
    `loop_scene.fixed_samples`."""
    from orbslam3_tpu_torch.pipeline import map_merging
    from orbslam3_tpu_torch.utils import atlas_scene, loop_scene
    cfg = system.SlamConfig(cam_params=loop_scene.K4, image_hw=(480, 752),
                            enable_loop_closing=True,
                            map_capacity=MapCapacity(n_kf=32, n_pt=4096, n_obs=16384))
    sys_ = system.System(cfg, device=device)
    ff = atlas_scene.two_sessions(sys_)
    assert map_merging.try_merge(sys_, ff, 1, idx_fn=loop_scene.fixed_samples)
    return sys_


def test_try_merge_on_the_card_matches_the_cpu(dev):
    """The two-session scene welded on the card and on the CPU with the same
    Sim3 samples: the same outcome (session, candidate, matches, inliers,
    offsets), the world Sim3 within 1e-4; the merged map's and bank's
    integer fields equal, poses within 1e-4 and points within 1e-4 of the
    scene's extent after the welding BA; the database rebuilt over the same
    keyframes; everything on the card."""
    c, g = _merged("cpu"), _merged(dev)
    keys = ("session", "kf", "cand", "n_matches", "n_inliers", "kf_off", "pt_off")
    assert [c.last_merge[k] for k in keys] == [g.last_merge[k] for k in keys]
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(g.last_merge[k], c.last_merge[k], atol=1e-4)
    assert g.map.kf_R.device == dev and g.bank.kp_pt.device == dev
    extent = float(c.map.pt_xyz.abs().max())
    for name, a in g.map._asdict().items():
        b = getattr(c.map, name)
        if a.is_floating_point():
            tol = 1e-4 * extent if name == "pt_xyz" else 1e-4
            torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=0, msg=name)
        else:
            assert torch.equal(a.cpu(), b), name
    for a, b in zip(g.bank, c.bank):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(g.loop_closer.db.active.cpu(), c.loop_closer.db.active)


def test_gnss_ba_on_the_card_matches_the_cpu(dev):
    """`system.gnss_ba` (the capacity-wide temporal window with position
    priors through the COO PCG solve) on the merged two-session map, the
    card against the CPU from the same inputs: keyframe centres within 1e-3
    of the map's extent, points within 1e-3 of it."""
    c = _merged("cpu")
    K = c.cfg.map_capacity.n_kf
    rng = np.random.default_rng(0)
    centres = (-c.map.kf_R.transpose(1, 2) @ c.map.kf_t[..., None])[..., 0].numpy()
    pp = (centres + rng.normal(0, 0.05, centres.shape)).astype(np.float32)
    pw = np.zeros(K, np.float32)
    pw[:3] = 1.0 / 0.05 ** 2
    args = (c.map, 2, torch.from_numpy(pp), torch.from_numpy(pw), c.bank)
    ref = system.gnss_ba(c.cfg, c.cam_params, *args)
    mv = lambda x: type(x)(*(y.to(dev) for y in x)) if isinstance(x, tuple) else \
        x.to(dev) if isinstance(x, torch.Tensor) else x
    got = system.gnss_ba(c.cfg, c.cam_params.to(dev), *map(mv, args))
    assert got.kf_R.device == dev
    extent = float(ref.pt_xyz.abs().max())
    cg = (-got.kf_R.transpose(1, 2) @ got.kf_t[..., None])[..., 0].cpu()
    cr = (-ref.kf_R.transpose(1, 2) @ ref.kf_t[..., None])[..., 0]
    assert float((cg[:3] - cr[:3]).abs().max()) < 1e-3 * extent
    assert float((got.pt_xyz.cpu() - ref.pt_xyz).abs().max()) < 1e-3 * extent


def _stereo_pair(n_frames=1):
    """bench.py's first frames as rectified pairs (`sensor_scene`) and the
    StereoSystem configuration of chip_smoke.py's phase 11a, without the
    keyframe database."""
    import dataclasses
    from orbslam3_tpu_torch.utils import sensor_scene
    cfg = dataclasses.replace(ss.SceneConfig(), seed_frames=(), track_frames=tuple(range(n_frames)))
    slam, scfg = sensor_scene.stereo_configs(cfg, enable_relocalization=False)
    return ss.render_frames(cfg), sensor_scene.render_right_frames(cfg), slam, scfg


def test_track_stereo_on_the_card_matches_the_cpu(dev):
    """One pair through `track_stereo` on the card (extraction, stereo
    matching, the SSD refinement, the stereo initialization) and on the CPU
    from the card's keypoints and the same images: the same depths (valid
    equal, depth within 1e-4 relative), the same points from the same
    keypoints (integer fields of the map and the bindings equal), positions
    within 1e-4 relative."""
    from orbslam3_tpu_torch.pipeline import stereo_system
    left, right, slam, scfg = _stereo_pair()
    card = stereo_system.StereoSystem(slam, scfg, device=dev)
    cpu = stereo_system.StereoSystem(slam, scfg, device="cpu")
    st, _ = card.track_stereo(left[0], right[0], 0.0)
    ffs = [extractor.extract(torch.from_numpy(im).to(dev), slam.orb) for im in (left[0], right[0])]
    cpu_ff = [type(f)(*(x.cpu() for x in f)) for f in ffs]
    sc, _ = cpu.track_stereo(left[0], right[0], 0.0, features_l=cpu_ff[0], features_r=cpu_ff[1])
    assert st == sc == system.OK
    np.testing.assert_array_equal(card._depth.valid.cpu().numpy(), cpu._depth.valid.numpy())
    ok = cpu._depth.valid.numpy()
    np.testing.assert_allclose(card._depth.depth.cpu().numpy()[ok], cpu._depth.depth.numpy()[ok],
                               rtol=1e-4)
    for name in ("n_pt", "n_obs", "pt_valid", "obs_pt", "obs_kf", "obs_valid"):
        assert torch.equal(getattr(card.map, name).cpu(), getattr(cpu.map, name)), name
    assert torch.equal(card.bank.kp_pt.cpu(), cpu.bank.kp_pt)
    v = cpu.map.pt_valid
    a, b = card.map.pt_xyz.cpu()[v], cpu.map.pt_xyz[v]
    assert int(v.sum()) > 100
    assert bool(((a - b).norm(dim=1) <= 1e-4 * b.norm(dim=1)).all())


def test_orb_describe_launches_twice_per_stereo_frame(dev):
    """`track_stereo` extracts both images: `orb_describe` twice per pair,
    the single kernels never; features handed in are not extracted again."""
    from orbslam3_tpu_torch.pipeline import stereo_system
    left, right, slam, scfg = _stereo_pair(3)
    sys_ = stereo_system.StereoSystem(slam, scfg, device=dev)
    orb_patches.reset_counters()
    for i in range(3):
        sys_.track_stereo(left[i], right[i], i / 10.0)
    assert orb_patches.launch_counts() == orb_patches.path_counts(6)
    assert sys_.state == system.OK
    ff = extractor.extract(torch.from_numpy(left[2]).to(dev), slam.orb)
    orb_patches.reset_counters()
    sys_.track_stereo(None, None, 0.3, features_l=ff, features_r=ff)
    assert orb_patches.launch_counts()["orb_describe"] == 0


def test_fisheye_stereo_match_on_the_card_matches_the_cpu(dev):
    """`fisheye_stereo_match` on the TUM-VI rig of phase 11c with 600 points
    out to 80 degrees off the axis: the same matches on the card as on the
    CPU, X within 1e-4 of its distance, every X finite."""
    from orbslam3_tpu_torch.features.extractor import FeatureFrame
    from orbslam3_tpu_torch.features import stereo
    from orbslam3_tpu_torch.ops import cameras
    from orbslam3_tpu_torch.utils import sensor_scene
    scn = sensor_scene.FisheyeSIScene()
    R_rel, t_rel, _ = scn.rig()
    rng = np.random.default_rng(7)
    n = 600
    th = np.arccos(rng.uniform(np.cos(1.4), 1.0, n))
    ph = rng.uniform(0, 2 * np.pi, n)
    d = rng.uniform(1.0, 3.0, n)
    X = np.stack([np.sin(th) * np.cos(ph) * d, np.sin(th) * np.sin(ph) * d, np.cos(th) * d], 1)
    P = torch.tensor(scn.kb8, dtype=torch.float32)
    desc = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32))

    def frame(Xc):
        uv = cameras.kb8_project(P, torch.from_numpy(Xc.astype(np.float32)))
        uv = uv + 0.2 * torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
        return FeatureFrame(xy=uv, response=torch.ones(n), octave=torch.zeros(n, dtype=torch.int32),
                            angle=torch.zeros(n), desc=desc, valid=torch.ones(n, dtype=torch.bool))

    f_l, f_r = frame(X), frame(X @ R_rel.T + t_rel)
    args = [P, P, torch.from_numpy(R_rel.astype(np.float32)), torch.from_numpy(t_rel.astype(np.float32))]
    ref = stereo.fisheye_stereo_match(f_l, f_r, *args)
    to = lambda f: type(f)(*(x.to(dev) for x in f))
    got = stereo.fisheye_stereo_match(to(f_l), to(f_r), *(a.to(dev) for a in args))
    assert torch.equal(got.valid.cpu(), ref.valid) and torch.equal(got.ridx.cpu(), ref.ridx)
    assert int(ref.valid.sum()) > 0.5 * n
    scale = ref.X.norm(dim=1).clamp_min(1.0)
    assert bool(((got.X.cpu() - ref.X).norm(dim=1) <= 1e-4 * scale).all())
    assert bool(torch.isfinite(got.X).all())


def test_run_euroc_mono_arm_on_the_card(dev, tmp_path, capsys):
    """The sequence runner's mono arm on the card for 20 frames of the
    EuRoC-layout tree: `orb_describe` once per frame, the decoder named on
    the first line (the native ingest where it builds, else the host path
    with the reason), the System's state on the card, and no blocking read
    at the frame's upload (pinned and asynchronous)."""
    from orbslam3_tpu_torch.io import native_ingest
    from orbslam3_tpu_torch.tools import run_euroc
    from orbslam3_tpu_torch.utils import euroc_scene, sync_census
    tree = euroc_scene.write_tree(str(tmp_path / "seq"), 20)
    native_ingest.available()          # build (or fail to) before counting
    found = []
    orb_patches.reset_counters()
    with sync_census._sync_warnings(found):
        res = run_euroc.main([tree, "--mode", "mono", "--out", str(tmp_path / "t.txt")])
    assert orb_patches.launch_counts() == orb_patches.path_counts(20)
    first = capsys.readouterr().out.splitlines()[0]
    if native_ingest.available():
        assert first == "ingest: native"
    else:
        assert first.startswith("ingest: host (native ingest library unavailable: ")
    sys_ = res["system"]
    assert sys_.map.pt_xyz.device.type == "cuda" and sys_.n_resets == 0
    assert len(sys_.trajectory) > 12
    assert not any("_image_on_device" in s or "_extract" in s for s in found), found


def test_extract_bench_on_the_card_matches_the_cpu(dev):
    """`drive_extract_bench` on the card: one `orb_describe` per extraction
    (the first call, the chain, the profiled steps), a device time per
    `extract` with `orb_describe`'s share of it; its frame extracted on the
    card and on the CPU: the same level-0 keypoints and descriptors."""
    from orbslam3_tpu_torch.tools.drives import drive_extract_bench as bench
    orb_patches.reset_counters()
    res = bench.main(["4"])
    assert orb_patches.launch_counts() == orb_patches.path_counts(1 + 4 + bench.N_PROFILED)
    assert res["device_ms"] > 0 and 0 < res["orb_describe_share"] < 1
    assert res["kernels_per_extract"] > 1 and len(res["top"]) == 5
    img = torch.from_numpy(bench.make_frames(1)[0])
    p = OrbParams(n_features=1200, n_levels=8)
    ff = extractor.extract(img.to(dev), p)
    ref = extractor.extract(img, p)
    lv0 = ref.octave == 0
    assert int(lv0.sum()) > 100
    assert torch.equal(ff.xy.cpu()[lv0], ref.xy[lv0])
    assert torch.equal(ff.desc.cpu()[lv0], ref.desc[lv0])


def test_recall_rows_on_the_card_match_the_cpu(dev):
    """The recall curve's descriptors made on the card (`orb_describe` twice
    per place), then its rows scored on the card and on the CPU from them:
    the same recall@1 and recall@3, margins within 1e-5."""
    from orbslam3_tpu_torch.tools import vocab_recall_curve as rc
    orb_patches.reset_counters()
    desc = rc.make_descriptors(4, 8, dev)
    assert orb_patches.launch_counts()["orb_describe"] == 8
    got = rc.recall_rows(desc, (4096,), (2, 4), dev, echo=False)
    ref = rc.recall_rows(desc, (4096,), (2, 4), "cpu", echo=False)
    assert [r[:4] for r in got] == [r[:4] for r in ref]
    np.testing.assert_allclose([r[4] for r in got], [r[4] for r in ref], atol=1e-5, rtol=0)


@pytest.mark.parametrize("comm", ["matvec", "dense", "camshard"])
def test_dist_ba_on_the_card_matches_the_cpu(dev, comm):
    """8 local shards of the card against the same solve on the CPU: R, t
    and X within 1e-4, both at the truth within 5e-3; a second solve on the
    card bit-equal to the first (the sums are deterministic)."""
    from orbslam3_tpu_torch.parallel import dist_ba, multihost
    from orbslam3_tpu_torch.utils import dist_scene

    prob, (_, t_gt, X_gt) = dist_scene.problem(8, 2048, 8192)
    cam = torch.tensor(dist_scene.K4)

    def solve(device):
        p = dist_ba.partition_problem(type(prob)(*(x.to(device) for x in prob if x is not None)), 8)
        return dist_ba.dist_bundle_adjust(p, multihost.Mesh(8), cam_params=cam.to(device),
                                          iterations=4, comm=comm)

    got, again, ref = solve(dev), solve(dev), solve("cpu")
    for g, r in zip(got[:3], ref[:3]):
        assert float((g.cpu() - r).abs().max()) < 1e-4
    assert float((got[1].cpu() - t_gt).norm(dim=1).max()) < 5e-3
    assert float((got[2].cpu() - X_gt).norm(dim=1).mean()) < 5e-3
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_system_with_its_window_ba_sharded_on_the_card(dev):
    """test_engine_mesh's scene with ba_mesh_shards=8 on the card and on
    one device through the COO solver: JAX's gates."""
    from orbslam3_tpu_torch.utils import engine_mesh

    sharded = engine_mesh.run(engine_mesh.config(ba_mesh_shards=8), dev)
    one = engine_mesh.run(engine_mesh.config(), dev, coo=True)
    assert not engine_mesh.gates(one, sharded)
    assert sharded[0].map.pt_xyz.device.type == "cuda"


def test_bench_chains_on_the_card_match_the_cpu(dev):
    """`orbslam3_tpu_torch.bench` at cut sizes on the card: the tracking chain
    at 3 frames against the same chain on the CPU (the first frame, which
    tracks the map's own image, within 1e-4 and 1% of the inliers;
    `bench.tracking_faults`: the later frames match nothing, and their poses,
    NaN on the CPU, stay finite on the card); the full chain at 18 frames (6
    timed, one keyframe step) within phase 6's ATE gate, its first timed frame
    and keyframe step again on the CPU from the same state
    (`bench.recheck_on_cpu`), its reads counted per frame kind; `orb_describe`
    once per extraction."""
    from orbslam3_tpu_torch import bench

    orb_patches.reset_counters()
    card = bench.bench_tracking_chain(dev, iters=3)
    assert orb_patches.launch_counts() == orb_patches.path_counts(1 + 1 + 3 + 3)
    cpu = bench.bench_tracking_chain("cpu", iters=3)
    assert bench.tracking_faults(card) == []
    (_, Rg, tg, ng), (_, Rc, tc, nc) = card.frames[0], cpu.frames[0]
    assert np.abs(Rg - Rc).max() <= 1e-4 and np.abs(tg - tc).max() <= 1e-4
    assert abs(ng - nc) <= 0.01 * nc and nc > 200
    assert set(card.reads) == {"tracked"} and card.reads["tracked"] >= 0

    orb_patches.reset_counters()
    full = bench.bench_full_system(dev, measure=18)
    assert orb_patches.launch_counts() == orb_patches.path_counts(
        bench.FULL_WARMUP + 18 + bench.SETTLE)
    assert full.keyframes == 1 and full.info["points"] > 200
    rmse, _, span = full.info["ate"]
    assert rmse < 0.08 * span
    assert set(full.reads) == {"tracked", "keyframe"}
    bad, _ = bench.recheck_on_cpu(full)
    assert bad == []



def test_a_system_draws_the_cpus_samples_on_the_card(dev):
    """A System keeps a CPU generator (`ops/sampling.py`): on the card and
    on the CPU the same seed gives the same two-view, MLPnP and Sim3
    samples, in the same order."""
    from orbslam3_tpu_torch.geometry import sim3solver, twoview
    from orbslam3_tpu_torch.ops import sampling
    cfg = system.SlamConfig(enable_relocalization=False)
    card, cpu = system.System(cfg, device=dev), system.System(cfg, device="cpu")
    assert card.generator.device == cpu.generator.device == torch.device("cpu")
    valid = torch.arange(300) % 3 != 0
    w = torch.rand(4, 300, generator=torch.Generator().manual_seed(1))
    for s in (card, cpu):
        s.draws = [twoview.sample_indices(valid.to(s.device), s.generator),
                   sampling.multinomial(w.to(s.device), 60, s.generator),
                   sim3solver.sample_indices(valid.to(s.device), 128, s.generator)]
    for a, b in zip(card.draws, cpu.draws):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


def test_j_tracked_frame_on_the_card_matches_the_cpu(dev):
    """Acceptance scenario J on the card, its first three pairs through
    `track_stereo` (the stereo initialization, then two tracked frames):
    the first left image's extraction on the CPU has the same keypoints;
    each tracked frame again on a CPU copy of the state before it
    (`acceptance.system_to`) gives the pose within 1e-4 and the same
    inliers; `orb_describe` twice per pair.  The first tracked frame is
    taken at the initialization's pose, where every predicted scale level
    lies within a float rounding of an integer (on an H100 its pose came
    out 1.3e-3 from the CPU's, with 299 inliers against 298), so the CPU
    runs it with the card's predicted levels (`drive(with_levels=1)`): the
    gate reads that run, and the run without them is reported."""
    from orbslam3_tpu_torch.pipeline import stereo_inertial_system
    from orbslam3_tpu_torch.utils import acceptance as acc
    rect = acc.j_rectification()
    pairs = acc.j_pairs(range(3), rect)
    sys_ = stereo_inertial_system.StereoInertialSystem(*acc.j_configs(rect), device=dev)

    def step(s, i):
        for sample in acc.j_imu(i):
            s.grab_imu(*sample)
        s.track_stereo(*pairs[i], ts=i / acc.J_FPS)

    orb_patches.reset_counters()
    d = acc.drive(sys_, 3, step, dev, keep_copy=True, hold=2, with_levels=1)
    assert orb_patches.launch_counts() == orb_patches.path_counts(6)
    assert d.init_frame == 0 and [h.frame for h in d.held] == [1, 2]
    assert sys_.state == system.OK
    bad, out = acc._track_check(d, step)
    print(out)
    assert bad == [] and out[0]["inliers"][0] > 100 and out[1]["inliers"][0] > 100, out
    ff = extractor.extract(torch.from_numpy(pairs[0][0]).to(dev), sys_.cfg.orb)
    bad, out = acc._extract_check(pairs[0][0], ff, sys_.cfg.orb)
    assert bad == [] and out["n_valid"] == 800, out


def test_orb_describe_on_a_rectified_atlas_matches_plain(dev):
    """`orb_describe` on the atlas of J's first rectified left image (384x384
    over 8 levels, 800 keypoints): moments bit-equal to `ic_moments`',
    descriptors bit-identical to the plain version's at the kernel's own
    angles, the angles within 0.01 degrees of the plain version's."""
    from orbslam3_tpu_torch.utils import acceptance as acc
    img = acc.j_pairs(range(1))[0][0]
    sel = extractor.select_keypoints(torch.from_numpy(img).to(dev), acc.j_configs()[0].orb)
    atlas, blur, xy = sel.atlas, sel.atlas_blur, sel.xy_atlas
    angle, desc, mom = orb_patches.orb_describe(atlas, blur, xy, with_moments=True)
    angle_p, _ = orb_patches.describe_plain(atlas, blur, xy)
    assert xy.shape[0] == 800
    assert torch.equal(mom, orb_patches.ic_moments(atlas, xy))
    assert torch.equal(desc, brief.compute_descriptors(blur, xy, angle))
    d = (angle - angle_p).abs()
    assert float(torch.minimum(d, 360.0 - d).max()) <= 0.01
