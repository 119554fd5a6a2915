"""ORB feature extraction (pyramid -> FAST -> uniform select -> IC-angle ->
rBRIEF), counterpart of `orbslam3_tpu/features/extractor.py`.

Two-threshold behaviour: both FAST tiers come from one low-threshold score
map and the low tier is masked in only when the high tier is short.
Orientation and descriptors run once over a vertically packed pyramid
atlas through the ORB patch kernels (`ops/orb_patches.py`); which
implementation runs is chosen by the tensor's device, where the JAX
package chose by backend (extractor.py:164-181).

Output is a fixed-capacity FeatureFrame with a validity mask; keypoint
coordinates are level-0 pixels (scaled by scale_factor^octave).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fast, gridselect, image, orb_patches


@dataclasses.dataclass(frozen=True)
class OrbParams:
    """Static extraction config (defaults = the EuRoC configuration: 1200
    features, 8 levels, 1.2 scale, FAST 20/7)."""
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    border: int = 19          # upstream EDGE_THRESHOLD
    max_candidates: int = 2048  # per-level FAST candidate cap (level 0)

    def features_per_level(self) -> list[int]:
        """Geometric budget (src/ORBextractor.cc:113-124)."""
        f = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        per = []
        total = 0
        for _ in range(self.n_levels - 1):
            per.append(int(round(n_desired)))
            total += per[-1]
            n_desired *= f
        per.append(max(self.n_features - total, 0))
        return per

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)

    def level_sigma2(self) -> np.ndarray:
        return self.scale_factors() ** 2


class FeatureFrame(NamedTuple):
    """Fixed-capacity SoA keypoint set for one image."""
    xy: torch.Tensor        # (N, 2) f32, level-0 pixel coords
    response: torch.Tensor  # (N,) f32
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) f32 degrees
    desc: torch.Tensor      # (N, 8) int32 bit patterns of the 256-bit descriptor
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


class Selection(NamedTuple):
    """Selected keypoints plus the packed atlases the patch kernels read."""
    atlas: torch.Tensor       # (sum h_l, W0) raw pyramid, levels stacked
    atlas_blur: torch.Tensor  # same layout, blurred and integer-rounded
    xy_atlas: torch.Tensor    # (N, 2) keypoint coords in the atlas
    xy: torch.Tensor          # (N, 2) level-0 coords
    response: torch.Tensor
    octave: torch.Tensor
    valid: torch.Tensor


def _level_grid(budget: int, h: int, w: int) -> tuple[int, int]:
    """Grid with ~budget cells at the image aspect ratio."""
    rows = max(1, int(round(np.sqrt(budget * h / w))))
    cols = max(1, int(np.ceil(budget / rows)))
    return rows, cols


def _select_level(img_lv, budget: int, cand_cap: int, p: OrbParams):
    """FAST + candidate top-k + uniform selection for one pyramid level."""
    h, w = img_lv.shape
    score = fast.detect(img_lv, p.min_th_fast, border=max(p.border, 3))
    flat = score.reshape(-1)
    # blocked two-stage top-k: per-block top-8.  A stable descending sort
    # keeps the lower index first on ties, as lax.top_k does (integer FAST
    # scores tie often; torch.topk orders ties differently)
    k_per = 8
    n_blocks = max(cand_cap // k_per, 1)
    pad = (-flat.shape[0]) % n_blocks
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(n_blocks, -1)
    bv, bi = torch.sort(blocks, dim=1, descending=True, stable=True)
    top_v = bv[:, :k_per].reshape(-1)
    top_i = (bi[:, :k_per] + torch.arange(n_blocks, device=flat.device)[:, None]
             * blocks.shape[1]).reshape(-1)
    top_i = torch.clamp_max(top_i, flat.shape[0] - 1)
    ys = (top_i // w).to(torch.float32)
    xs = (top_i % w).to(torch.float32)
    xy = torch.stack([xs, ys], dim=-1)
    is_corner = top_v > 0
    is_high = top_v >= p.ini_th_fast

    # two-threshold gate (see module docstring); stays on the device
    n_high = torch.sum(is_high.to(torch.int32))
    use_low = n_high < int(0.75 * 3 * budget)  # FAST budget ~3x kp budget
    valid = is_corner & (is_high | use_low)

    sel = gridselect.select_uniform(xy, top_v, valid, (h, w),
                                    _level_grid(budget, h, w), budget)
    ok = sel >= 0
    sel_c = torch.clamp_min(sel, 0)
    return xy[sel_c], top_v[sel_c], ok


def select_keypoints(img: torch.Tensor, p: OrbParams) -> Selection:
    """Pyramid, FAST and per-level selection, plus the packed atlases."""
    img = img.to(torch.float32)
    pyr, blurred = image.build_pyramid(img, p.n_levels, p.scale_factor)
    budgets = p.features_per_level()
    sf = p.scale_factors()
    w0 = pyr[0].shape[1]
    row_off = np.cumsum([0] + [q.shape[0] for q in pyr[:-1]]).tolist()

    xs_lv, rs, os_, vs, xs_atlas = [], [], [], [], []
    for lv in range(p.n_levels):
        area_ratio = (pyr[lv].shape[0] * pyr[lv].shape[1]) / (
            pyr[0].shape[0] * pyr[0].shape[1])
        cap = max(256, min(int(p.max_candidates * area_ratio),
                           pyr[lv].shape[0] * pyr[lv].shape[1]))
        kxy, kresp, ok = _select_level(pyr[lv], budgets[lv], cap, p)
        xs_lv.append(kxy * float(sf[lv]))  # level-0 coords for the output
        xs_atlas.append(torch.stack([kxy[:, 0], kxy[:, 1] + float(row_off[lv])],
                                    dim=-1))
        rs.append(kresp)
        os_.append(torch.full((budgets[lv],), lv, dtype=torch.int32,
                              device=img.device))
        vs.append(ok)

    def pack(levels):
        return torch.cat([torch.nn.functional.pad(q, (0, w0 - q.shape[1]))
                          for q in levels], dim=0)

    return Selection(atlas=pack(pyr), atlas_blur=pack(blurred),
                     xy_atlas=torch.cat(xs_atlas), xy=torch.cat(xs_lv),
                     response=torch.cat(rs), octave=torch.cat(os_),
                     valid=torch.cat(vs))


def extract(img: torch.Tensor, p: OrbParams) -> FeatureFrame:
    """img: (H, W) grayscale 0..255, uint8 or float32, on the device that
    should run the extraction (feed uint8: 4x cheaper to transfer).

    After per-level selection, orientation and descriptors run once over
    the packed pyramid atlas: patches stay level-local because the
    selection border (>= 19 px) covers both patch radii.
    """
    s = select_keypoints(img, p)
    angle, desc = orb_patches.ic_angle_and_descriptors(
        s.atlas, s.atlas_blur, s.xy_atlas)
    return FeatureFrame(xy=s.xy, response=s.response, octave=s.octave,
                        angle=angle, desc=desc, valid=s.valid)
