"""The port's extraction held against the JAX package on every pyramid level
at full size: the default `OrbParams` (480x752, 1200 features over 8
levels), on `seeded_scene`'s rendered frames and on two of the recall
curve's frames (`tools/vocab_recall_curve.make_descriptors`: a place's
nominal view and its stressed revisit).

JAX runs `extract_jit` on the CPU, which takes `orient.ic_angle` and
`brief.compute_descriptors` (orbslam3_tpu/features/extractor.py:164-181); the
port runs `extractor.extract` on a CPU tensor, which takes the plain versions
of its kernels.  Inputs are numpy arrays handed to both.

Only two causes of a difference are allowed: the resize's float order (T1:
the level images agree within 3.2e-6, see
test_torch_frontend.py::test_resize_and_pyramid_match_jax) and blur ties at
.5 (a blurred pixel rounded the other way).  Either can move a FAST response
or an angle by a hair; anything else would be a fault of the port.

Measured on the CPU (4 frames; the same at 1, 2, 4 and 6 torch threads):
every level of every frame has the same valid keypoints at the same
coordinates in both (261 / 217 / 181 / 151 / 126 / 105 / 87 / 72 on levels
0-7), the same octaves, the same angle bin at every keypoint and the same
256 descriptor bits.  Level 0 (integer pixels) has bit-equal angles; above
it the angles differ by at most 0.0083 degrees (T1, the moments summed over
level images that differ in the last bits).  The recall curve's own
parameters (800 features over 4 levels) give the same agreement on its two
frames.  The bounds below are those measurements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu_torch.features import extractor as tx
from orbslam3_tpu_torch.ops import brief
from orbslam3_tpu_torch.tools import vocab_recall_curve as rc
from orbslam3_tpu_torch.utils import seeded_scene as ss

torch.set_num_threads(2)

# above level 0: at most this many degrees between the two angles (measured
# 0.0083, T1)
ANGLE_TOL_DEG = 0.02


def _recall_frames(monkeypatch) -> list:
    """The first place's two views as the recall curve renders them."""
    imgs = []
    real = tx.extract

    def spy(img, p):
        imgs.append(img.numpy().copy())
        return real(img, tx.OrbParams(n_features=64, n_levels=2))

    monkeypatch.setattr(tx, "extract", spy)
    rc.make_descriptors(1, 8, "cpu")
    monkeypatch.setattr(tx, "extract", real)
    return imgs


def _frame(which: str, monkeypatch) -> np.ndarray:
    if which.startswith("recall"):
        return _recall_frames(monkeypatch)[0 if which == "recall_db" else 1]
    cfg = ss.SceneConfig()
    frames = ss.render_frames(cfg)
    return frames[cfg.seed_frames[0] if which == "seeded_first" else cfg.track_frames[-1]]


def per_level(fj, ft, n_levels: int) -> list:
    """Per level: (JAX's valid keypoints, the port's, the share they have in
    common, the share of common keypoints in the same angle bin, the largest
    angle difference in degrees at common keypoints, the largest number of
    descriptor bits that differ at common keypoints)."""
    xt, vt = ft.xy.numpy(), ft.valid.numpy()
    at, dt = ft.angle.numpy(), ft.desc.numpy().view(np.uint32)
    aj, dj = np.asarray(fj.angle), np.asarray(fj.desc)
    rows = []
    for lv in range(n_levels):
        idx = np.nonzero(fj.octave == lv)[0]
        kj = {tuple(fj.xy[i].tolist()): i for i in idx if fj.valid[i]}
        kt = {tuple(xt[i].tolist()): i for i in idx if vt[i]}
        common = sorted(set(kj) & set(kt))
        ij = np.array([kj[c] for c in common], int)
        it = np.array([kt[c] for c in common], int)
        same_bin = (brief.angle_bins(torch.from_numpy(aj[ij])) ==
                    brief.angle_bins(torch.from_numpy(at[it]))).numpy()
        d = np.abs(aj[ij] - at[it])
        d = np.minimum(d, 360.0 - d)
        bits = np.unpackbits((dj[ij] ^ dt[it]).view(np.uint8), axis=1).sum(1)
        rows.append((len(kj), len(kt), len(common) / max(len(kj), len(kt)),
                     float(same_bin.mean()), float(d.max()), int(bits.max())))
    return rows


@pytest.mark.parametrize("which", ["seeded_first", "seeded_last", "recall_db", "recall_q"])
def test_extract_every_level_matches_jax_at_full_size(which, monkeypatch):
    img = _frame(which, monkeypatch)
    assert img.shape == (480, 752)
    pj, pt = jx.OrbParams(), tx.OrbParams()
    assert (pt.n_features, pt.n_levels) == (pj.n_features, pj.n_levels) == (1200, 8)
    fj = jax.device_get(jx.extract_jit(jnp.asarray(img), pj))
    ft = tx.extract(torch.from_numpy(img), pt)
    np.testing.assert_array_equal(ft.octave.numpy(), fj.octave)
    rows = per_level(fj, ft, pt.n_levels)
    for lv, (nj, nt, share, bins, dang, bits) in enumerate(rows):
        assert nj == nt == pt.features_per_level()[lv], (which, lv, rows[lv])
        assert share == 1.0, (which, lv, rows[lv])
        assert bins == 1.0, (which, lv, rows[lv])
        assert bits == 0, (which, lv, rows[lv])
        assert dang <= (0.0 if lv == 0 else ANGLE_TOL_DEG), (which, lv, rows[lv])
    lv0 = fj.octave == 0
    np.testing.assert_array_equal(ft.angle.numpy()[lv0], np.asarray(fj.angle)[lv0])
