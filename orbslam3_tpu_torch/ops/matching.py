"""Descriptor matching: masked Hamming nearest neighbour + the projection gate.

Counterpart of `orbslam3_tpu/ops/matching.py` for what initialization,
tracking and mapping use: `match_nn` with its mask, distance, ratio, mutual
and rotation-histogram gates, `window_mask`, `projection_mask`,
`epipolar_mask`, `search_for_initialization` and `search_by_brute_force`.  Every
strategy is a full (N x M) distance matrix (one unpacked-bit matmul) plus a
compatibility mask, an argmin and gates.

Tie rules kept from JAX: `torch.argmin` returns the first minimum, as
`jnp.argmin` does; the histogram's top-3 bins use a stable descending sort,
which keeps the lower bin first as `lax.top_k` does; the duplicate-target
resolution keys `dist * n + row` stay int32 by clamping the distance to 9
bits (matching.py:88-92).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import brief

TH_LOW = 30   # this fork tightened TH_LOW from upstream's 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1 << 20
_I32_MAX = 2 ** 31 - 1


class Matches(NamedTuple):
    idx: torch.Tensor    # (N,) int32 index into B per A row, -1 if none
    dist: torch.Tensor   # (N,) int32 best Hamming distance
    valid: torch.Tensor  # (N,) bool


def rotation_histogram_filter(rot_deg: torch.Tensor, valid: torch.Tensor,
                              n_keep: int = 3) -> torch.Tensor:
    """Keep matches whose relative rotation falls in the top-`n_keep` of
    HISTO_LENGTH bins (reference ORBmatcher rotation-consistency check)."""
    # jnp.mod: C remainder, moved into [0, 360) when it has the wrong sign
    rot = torch.fmod(rot_deg, 360.0)
    rot = torch.where((rot != 0) & (rot < 0), rot + 360.0, rot)
    b = torch.round(rot * (HISTO_LENGTH / 360.0)).to(torch.int32)
    b = torch.where(b == HISTO_LENGTH, 0, b)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=b.device)
    hist = hist.index_add(0, b.long(), valid.to(torch.int32))
    top_counts, top_bins = torch.sort(hist, descending=True, stable=True)
    top_counts, top_bins = top_counts[:n_keep], top_bins[:n_keep]
    # reference ComputeThreeMaxima: drop 2nd/3rd maxima below 10% of the 1st
    keep_bin = top_counts.to(torch.float32) >= 0.1 * top_counts[0]
    in_top = ((b[:, None] == top_bins[None, :]) & keep_bin[None, :]).any(dim=-1)
    return valid & in_top


def match_nn(desc_a: torch.Tensor, desc_b: torch.Tensor,
             mask: torch.Tensor | None = None,
             max_dist: int = TH_LOW,
             nn_ratio: float | None = None,
             mutual: bool = False,
             angles_a: torch.Tensor | None = None,
             angles_b: torch.Tensor | None = None,
             check_rotation: bool = False) -> Matches:
    """Nearest-neighbour Hamming matching A->B with gates.

    mask: (N, M) bool of allowed pairs; nn_ratio: best < ratio * second;
    mutual: A must also be B's best; check_rotation: the relative keypoint
    angles (degrees) must fall in the rotation histogram's top bins.
    A column claimed by several rows goes to the row with the lowest
    (distance, row).
    """
    d = brief.hamming_distance(desc_a, desc_b)  # (N, M) int32
    if mask is not None:
        d = torch.where(mask, d, BIG)
    n, m = d.shape
    rows = torch.arange(n, device=d.device)

    best_idx = torch.argmin(d, dim=1)
    best = d[rows, best_idx]
    is_best = torch.arange(m, device=d.device)[None, :] == best_idx[:, None]
    second = torch.amin(torch.where(is_best, BIG, d), dim=1)

    valid = best <= max_dist
    if nn_ratio is not None:
        valid &= best.to(torch.float32) < nn_ratio * second.to(torch.float32)
    if mutual:
        col_best = torch.argmin(d, dim=0)
        valid &= col_best[best_idx] == rows
    if check_rotation:
        valid = rotation_histogram_filter(angles_a - angles_b[best_idx], valid)

    order_key = torch.clamp_max(best, 512) * n + rows.to(torch.int32)
    col_winner = torch.full((m,), _I32_MAX, dtype=torch.int32, device=d.device)
    col_winner = col_winner.scatter_reduce(
        0, best_idx, torch.where(valid, order_key, _I32_MAX), "amin",
        include_self=True)
    valid &= col_winner[best_idx] == order_key

    best_idx = best_idx.to(torch.int32)
    return Matches(idx=torch.where(valid, best_idx, -1), dist=best, valid=valid)


def window_mask(xy_a: torch.Tensor, xy_b: torch.Tensor, radius: float,
                octave_a: torch.Tensor | None = None,
                octave_b: torch.Tensor | None = None,
                max_octave: int | None = None) -> torch.Tensor:
    """|xy_a - xy_b| window search (SearchForInitialization: the reference
    restricts to octave 0 via GetFeaturesInArea(level 0, 0)).  (N, M) bool."""
    dx = xy_a[:, None, 0] - xy_b[None, :, 0]
    dy = xy_a[:, None, 1] - xy_b[None, :, 1]
    m = (torch.abs(dx) <= radius) & (torch.abs(dy) <= radius)
    if max_octave is not None:
        m &= (octave_a[:, None] <= max_octave) & (octave_b[None, :] <= max_octave)
    return m


def projection_mask(uv_proj: torch.Tensor, pred_octave: torch.Tensor,
                    proj_valid: torch.Tensor, xy_f: torch.Tensor,
                    octave_f: torch.Tensor, kp_valid: torch.Tensor,
                    scale_factors: torch.Tensor, radius_th) -> torch.Tensor:
    """SearchByProjection gate (src/ORBmatcher.cc:31-124): the map point
    projected at uv with a predicted octave; search radius = radius_th *
    scale_factor[pred_octave]; keypoint octave in [pred-1, pred+1].
    Returns (P, N) bool."""
    r = radius_th * scale_factors[
        torch.clamp(pred_octave, 0, scale_factors.shape[0] - 1).long()]
    du = uv_proj[:, None, 0] - xy_f[None, :, 0]
    dv = uv_proj[:, None, 1] - xy_f[None, :, 1]
    close = (torch.abs(du) <= r[:, None]) & (torch.abs(dv) <= r[:, None])
    oct_ok = (octave_f[None, :] >= (pred_octave - 1)[:, None]) & \
             (octave_f[None, :] <= (pred_octave + 1)[:, None])
    return close & oct_ok & proj_valid[:, None] & kp_valid[None, :]


def epipolar_mask(xy_a: torch.Tensor, xy_b: torch.Tensor, F12: torch.Tensor,
                  sigma2_b: torch.Tensor, chi2_th: float = 3.84) -> torch.Tensor:
    """Point-to-epipolar-line gate for SearchForTriangulation (reference
    Pinhole::epipolarConstrain, src/CameraModels/Pinhole.cpp:104: squared
    line distance < 3.84 * sigma2 of the matched keypoint).  Returns (N, M)."""
    ones_a = torch.ones((xy_a.shape[0], 1), dtype=xy_a.dtype, device=xy_a.device)
    lines = torch.cat([xy_a, ones_a], dim=1) @ F12.T   # (N, 3) lines in image b
    num = lines[:, None, 0] * xy_b[None, :, 0] + \
        lines[:, None, 1] * xy_b[None, :, 1] + lines[:, None, 2]
    den = lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2
    dsqr = (num * num) / (den + 1e-12)
    return dsqr < chi2_th * sigma2_b[None, :]


def search_for_initialization(ff1, ff2, radius: float = 100.0,
                              nn_ratio: float = 0.9) -> Matches:
    """Two-frame initialization matching (reference
    Tracking::MonocularInitialization -> SearchForInitialization with
    windowSize=100 upstream)."""
    mask = window_mask(ff1.xy, ff2.xy, radius, ff1.octave, ff2.octave, max_octave=0)
    mask &= ff1.valid[:, None] & ff2.valid[None, :]
    return match_nn(ff1.desc, ff2.desc, mask, max_dist=TH_LOW, nn_ratio=nn_ratio,
                    angles_a=ff1.angle, angles_b=ff2.angle, check_rotation=True)


def search_by_brute_force(ff1, ff2, nn_ratio: float = 0.7, max_dist: int = TH_LOW,
                          check_rotation: bool = True) -> Matches:
    """Stand-in for SearchByBoW: the matmul matcher searches all pairs
    exactly, a superset of the BoW shared-node search at equal gates."""
    mask = ff1.valid[:, None] & ff2.valid[None, :]
    return match_nn(ff1.desc, ff2.desc, mask, max_dist=max_dist, nn_ratio=nn_ratio,
                    angles_a=ff1.angle, angles_b=ff2.angle,
                    check_rotation=check_rotation)
