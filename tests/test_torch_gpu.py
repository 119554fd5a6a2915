"""The ORB patch kernels (CUDA, sm_90a) against their plain PyTorch twins, and
the keyframe step on the card against the same step on the CPU.

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


def test_extract_launches_each_kernel_once(dev):
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.integers(0, 256, (240, 376)).astype(np.uint8)).to(dev)
    p = extractor.OrbParams(n_features=500, n_levels=4)
    orb_patches.reset_counters()
    ff = extractor.extract(img, p)
    torch.cuda.synchronize()
    assert (orb_patches.ic_moments_launches, orb_patches.brief_desc_launches) == (1, 1)
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
