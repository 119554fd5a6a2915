"""Descriptor matching: masked Hamming nearest neighbour + the projection gate.

Counterpart of `orbslam3_tpu/ops/matching.py` for what the tracking slice
uses (`match_nn` with mask, distance and ratio gates; `projection_mask`).
Every strategy is a full (N x M) distance matrix (one unpacked-bit matmul)
plus a compatibility mask, an argmin and gates.

Tie rules kept from JAX: `torch.argmin` returns the first minimum, as
`jnp.argmin` does; the duplicate-target resolution keys `dist * n + row`
stay int32 by clamping the distance to 9 bits (matching.py:88-92).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import brief

TH_LOW = 30   # this fork tightened TH_LOW from upstream's 50
TH_HIGH = 100
BIG = 1 << 20
_I32_MAX = 2 ** 31 - 1


class Matches(NamedTuple):
    idx: torch.Tensor    # (N,) int32 index into B per A row, -1 if none
    dist: torch.Tensor   # (N,) int32 best Hamming distance
    valid: torch.Tensor  # (N,) bool


def match_nn(desc_a: torch.Tensor, desc_b: torch.Tensor,
             mask: torch.Tensor | None = None,
             max_dist: int = TH_LOW,
             nn_ratio: float | None = None) -> Matches:
    """Nearest-neighbour Hamming matching A->B with gates.

    mask: (N, M) bool of allowed pairs; nn_ratio: best < ratio * second.
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

    order_key = torch.clamp_max(best, 512) * n + rows.to(torch.int32)
    col_winner = torch.full((m,), _I32_MAX, dtype=torch.int32, device=d.device)
    col_winner = col_winner.scatter_reduce(
        0, best_idx, torch.where(valid, order_key, _I32_MAX), "amin",
        include_self=True)
    valid &= col_winner[best_idx] == order_key

    best_idx = best_idx.to(torch.int32)
    return Matches(idx=torch.where(valid, best_idx, -1), dist=best, valid=valid)


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
