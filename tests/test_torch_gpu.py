"""The ORB patch kernels (CUDA, sm_90a) against their plain PyTorch twins.

These need an NVIDIA GPU with nvcc and are marked `gpu`; without a card they
skip.  With a GPU: `python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest`
(`tests/conftest.py` imports JAX, which a GPU machine for the port need not have).
"""

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.features import extractor
from orbslam3_tpu_torch.ops import brief, orb_patches, orient

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
