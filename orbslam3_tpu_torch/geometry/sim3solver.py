"""Sim(3) RANSAC between two matched 3D point sets (loop closure).

Counterpart of `orbslam3_tpu/geometry/sim3solver.py` (parity target:
reference Sim3Solver, src/Sim3Solver.cc: 3-point samples (:131), the
closed-form absolute orientation with scale (ComputeSim3, :311), inliers by
reprojection in both cameras (CheckInliers, :411)).  Every hypothesis is
fitted and scored in one batch (the Umeyama SVD of each 3-point sample),
then the winner is refitted on its inliers.

The sample indices are an argument: JAX draws them with
`jax.random.categorical` over the match weights valid + 1e-9 (sim3solver.py:54),
and JAX's and torch's generators give different draws from one seed.  When
`idx` is absent they are drawn from the same weights by `torch.multinomial`
with an explicit generator; the tests inject JAX's draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import align, cameras, lie
from ..slam_map.state import _row

CHI2_1 = 9.210   # reference th2, in both cameras


class Sim3Result(NamedTuple):
    success: torch.Tensor
    R12: torch.Tensor   # maps frame-2 coordinates into frame 1: x1 = s R x2 + t
    t12: torch.Tensor
    s12: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def sample_indices(valid: torch.Tensor, iterations: int,
                   generator: torch.Generator | None) -> torch.Tensor:
    """(iterations, 3) sample indices drawn from the weights valid + 1e-9."""
    w = valid.to(torch.float32) + 1e-9
    return torch.multinomial(w, iterations * 3, replacement=True,
                             generator=generator).reshape(iterations, 3)


def _score(P1, P2, uv1, uv2, valid, R, t, s, cam_model, cam_params):
    """Inliers of Sim3 hypotheses (R (..., 3, 3), t (..., 3), s (...)) by
    reprojection in both cameras: (counts (...), inlier masks (..., N))."""
    P2in1 = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, P2) + t[..., None, :]
    P1in2 = torch.einsum("...ni,...ij->...nj",
                         (P1 - t[..., None, :]) / torch.clamp_min(s, 1e-9)[..., None, None], R)
    e1 = uv1 - cameras.project(cam_model, cam_params, P2in1)
    e2 = uv2 - cameras.project(cam_model, cam_params, P1in2)
    ok = (torch.sum(e1 ** 2, -1) < CHI2_1) & (torch.sum(e2 ** 2, -1) < CHI2_1) & valid & \
        (P2in1[..., 2] > 0) & (P1in2[..., 2] > 0)
    return torch.sum(ok.to(torch.int32), dim=-1), ok


def solve_sim3(X1: torch.Tensor, X2: torch.Tensor, valid: torch.Tensor,
               uv1: torch.Tensor, uv2: torch.Tensor, Rcw1, tcw1, Rcw2, tcw2,
               cam_model: str, cam_params, iterations: int = 128, min_inliers: int = 20,
               fix_scale: bool = False, idx: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> Sim3Result:
    """X1, X2: (N, 3) matched map points in the world coordinates of
    keyframes 1 and 2; uv1 / uv2 their keypoints in keyframe 1 / 2; the
    poses are the keyframes' world -> camera transforms.  Aligns the
    camera-frame point sets, as the reference does (src/Sim3Solver.cc:55-75).
    `idx`: (iterations, 3) sample indices, drawn with `generator` when
    absent.  Returns a Sim3Result with every field on the device."""
    P1 = lie.se3_apply(Rcw1, tcw1, X1)
    P2 = lie.se3_apply(Rcw2, tcw2, X2)
    if idx is None:
        idx = sample_indices(valid, iterations, generator)
    idx = idx.long()
    Rs, ts, ss = align.umeyama_alignment(P2[idx], P1[idx], with_scale=not fix_scale)
    counts, inl = _score(P1, P2, uv1, uv2, valid, Rs, ts, ss, cam_model, cam_params)
    # argmax takes the first maximum, as jnp.argmax does
    best = torch.argmax(counts)
    c_best, inl_best = _row(counts, best), _row(inl, best)
    # refit on the inliers of the best hypothesis
    R, t, s = align.umeyama_alignment(P2, P1, with_scale=not fix_scale,
                                      weights=inl_best.to(torch.float32))
    n_fit, inl_fit = _score(P1, P2, uv1, uv2, valid, R, t, s, cam_model, cam_params)
    use_refit = n_fit >= c_best
    n_inl = torch.maximum(n_fit, c_best)
    return Sim3Result(success=n_inl >= min_inliers,
                      R12=torch.where(use_refit, R, _row(Rs, best)),
                      t12=torch.where(use_refit, t, _row(ts, best)),
                      s12=torch.where(use_refit, s, _row(ss, best)),
                      inliers=torch.where(use_refit, inl_fit, inl_best), n_inliers=n_inl)
