"""Stereo association: left-right ORB matching on rectified pairs, the
direct raw-fisheye pair triangulation, and the subpixel disparity refinement.

Counterpart of `orbslam3_tpu/features/stereo.py` (parity target: upstream
Frame::ComputeStereoMatches and KannalaBrandt8::TriangulateMatches).  Each
matcher is one masked Hamming nearest-neighbour search over all left x right
pairs (`matching.match_nn`): the row band, the disparity range, the octave
and the epipolar gates are terms of the mask.

Rounding as in JAX: `jnp.round` and `torch.round` both round half to even,
so the integer keypoint and right-u pixels come out the same;
`refine_disparity` takes the first of tied SSD minima, as `jnp.argmin`
does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cameras, lie, matching, triangulate


class StereoDepth(NamedTuple):
    ur: torch.Tensor      # (N,) right-image u coordinate (-1 if none)
    depth: torch.Tensor   # (N,) metric depth (0 if none)
    valid: torch.Tensor   # (N,) bool


def stereo_match(ff_l, ff_r, fx: float, baseline: float, row_tol: float = 2.0,
                 min_depth: float = 0.1, max_depth: float = 40.0,
                 scale_factor: float = 1.2) -> StereoDepth:
    """Associate left keypoints with right keypoints on a rectified pair:
    the same row within row_tol * scale_factor^octave, a disparity in the
    range that [min_depth, max_depth] allows, octaves at most one apart,
    then the best Hamming distance (TH_HIGH, ratio 0.9); depth = fx b / d."""
    min_disp = fx * baseline / max_depth
    max_disp = fx * baseline / min_depth
    du = ff_l.xy[:, None, 0] - ff_r.xy[None, :, 0]
    dv = torch.abs(ff_l.xy[:, None, 1] - ff_r.xy[None, :, 1])
    tol = row_tol * scale_factor ** ff_l.octave.to(torch.float32)
    mask = (dv <= tol[:, None]) & (du >= min_disp) & (du <= max_disp)
    mask &= ff_l.valid[:, None] & ff_r.valid[None, :]
    mask &= torch.abs(ff_l.octave[:, None] - ff_r.octave[None, :]) <= 1
    mm = matching.match_nn(ff_l.desc, ff_r.desc, mask, max_dist=matching.TH_HIGH,
                           nn_ratio=0.9)
    j = torch.clamp_min(mm.idx, 0).long()
    ur = ff_r.xy[j, 0]
    disp = torch.clamp_min(ff_l.xy[:, 0] - ur, 1e-3)
    depth = fx * baseline / disp
    ok = mm.valid & (depth > min_depth) & (depth < max_depth)
    return StereoDepth(ur=torch.where(ok, ur, -1.0), depth=torch.where(ok, depth, 0.0),
                       valid=ok)


class FisheyeStereo(NamedTuple):
    """Direct fisheye-pair triangulation (left-camera frame)."""
    X: torch.Tensor       # (N, 3) triangulated point per left keypoint
    depth: torch.Tensor   # (N,) left-camera z (0 if none)
    ridx: torch.Tensor    # (N,) matched right keypoint (-1 if none)
    valid: torch.Tensor   # (N,) bool


def _unit(b: torch.Tensor) -> torch.Tensor:
    return b / torch.clamp_min(torch.linalg.norm(b, dim=-1, keepdim=True), 1e-9)


def fisheye_stereo_match(ff_l, ff_r, params_l, params_r, R_rl, t_rl,
                         epipolar_th: float = 6e-3, min_depth: float = 0.1,
                         max_depth: float = 40.0, max_parallax_cos: float = 0.9998,
                         reproj_chi2: float = 5.991, scale_factor: float = 1.2,
                         cam_model: str = "kb8") -> FisheyeStereo:
    """Raw-fisheye stereo without rectification: descriptor matching gated
    by the epipolar constraint on unit bearings, then ray-pair DLT with the
    rig's extrinsic R_rl, t_rl (right <- left: x_r = R_rl x_l + t_rl).  A
    match is kept with parallax (cos < max_parallax_cos), positive depth in
    both cameras and a reprojection chi2 below `reproj_chi2` in both images
    under the octave noise model.

    Only the forward hemisphere is matched: the inhomogeneous DLT divides
    each ray by its z, so bearings with z <= 0.05 (beyond ~87 degrees) are
    taken out of the match mask, before any division, rather than fed to a
    division by ~0."""
    b_l = _unit(cameras.unproject(cam_model, params_l, ff_l.xy))
    b_r = _unit(cameras.unproject(cam_model, params_r, ff_r.xy))
    E = lie.hat(t_rl) @ R_rl
    res = torch.abs((b_l @ E.T) @ b_r.T)            # (N, M): b_r[m] . E b_l[n]
    fwd = (b_l[:, None, 2] > 0.05) & (b_r[None, :, 2] > 0.05)
    mask = fwd & (res < epipolar_th) & ff_l.valid[:, None] & ff_r.valid[None, :]
    mask &= torch.abs(ff_l.octave[:, None] - ff_r.octave[None, :]) <= 1
    mm = matching.match_nn(ff_l.desc, ff_r.desc, mask, max_dist=matching.TH_HIGH,
                           nn_ratio=0.9)
    j = torch.clamp_min(mm.idx, 0).long()
    br_m = b_r[j]
    # parallax: the right bearing rotated into the left frame
    cos_par = torch.sum(b_l * (br_m @ R_rl), dim=-1)
    eye = torch.eye(3, dtype=b_l.dtype, device=b_l.device)
    X = triangulate.triangulate_dlt(b_l, br_m, eye, torch.zeros_like(t_rl), R_rl, t_rl)
    z_l = X[:, 2]
    Xr = X @ R_rl.T + t_rl
    uv_l = cameras.project(cam_model, params_l, X)
    uv_r = cameras.project(cam_model, params_r, Xr)
    s2 = scale_factor ** (2.0 * ff_l.octave.to(torch.float32))
    e_l = torch.sum((uv_l - ff_l.xy) ** 2, dim=-1) / s2
    e_r = torch.sum((uv_r - ff_r.xy[j]) ** 2, dim=-1) / s2
    ok = mm.valid & (cos_par < max_parallax_cos) & (z_l > min_depth) & \
        (z_l < max_depth) & (Xr[:, 2] > 0) & (e_l < reproj_chi2) & (e_r < reproj_chi2)
    return FisheyeStereo(X=torch.where(ok[:, None], X, 0.0), depth=torch.where(ok, z_l, 0.0),
                         ridx=torch.where(ok, j.to(torch.int32), -1), valid=ok)


def refine_disparity(img_l: torch.Tensor, img_r: torch.Tensor, xy_l: torch.Tensor,
                     d: StereoDepth, fx: float, baseline: float, w: int = 5,
                     r_search: int = 2) -> StereoDepth:
    """Subpixel refinement of the matched right-u (upstream
    Frame::ComputeStereoMatches' sweep and parabola): the (2w+1)^2 left
    patch against right patches shifted by [-r_search, r_search] around the
    matched u, the SSD per shift, a parabola through the minimum and its
    neighbours.  A refinement that moved more than r_search + 1 or whose
    minimum sits on the sweep's edge keeps the matched u.  Images are
    (H, W) float32; the patches are one gather each."""
    h, wid = img_l.shape
    s = 2 * w + 1
    sw = s + 2 * r_search
    x_l = torch.round(xy_l[:, 0]).to(torch.int32)
    y = torch.clamp(torch.round(xy_l[:, 1]).to(torch.int32) - w, 0, h - s)
    xl0 = torch.clamp(x_l - w, 0, wid - s)
    ur_i = torch.round(d.ur).to(torch.int32)
    xr0 = torch.clamp(ur_i - w - r_search, 0, wid - sw)
    dev = img_l.device
    rows = (y[:, None, None] + torch.arange(s, device=dev)[None, :, None]).long()
    Pl = img_l[rows, (xl0[:, None, None] + torch.arange(s, device=dev)[None, None, :]).long()]
    Pr = img_r[rows, (xr0[:, None, None] + torch.arange(sw, device=dev)[None, None, :]).long()]
    # SSD per shift: the SSD of a shifted signal is locally quadratic in the
    # shift, so the parabola's vertex is unbiased (SAD's V biases it)
    ssd = torch.stack([torch.sum(torch.square(Pr[:, :, k:k + s] - Pl), dim=(1, 2))
                       for k in range(2 * r_search + 1)], dim=1)
    best = torch.argmin(ssd, dim=1)
    bc = torch.clamp(best, 1, 2 * r_search - 1)
    c0 = torch.gather(ssd, 1, (bc - 1)[:, None])[:, 0]
    c1 = torch.gather(ssd, 1, bc[:, None])[:, 0]
    c2 = torch.gather(ssd, 1, (bc + 1)[:, None])[:, 0]
    denom = c0 + c2 - 2 * c1
    frac = torch.where(torch.abs(denom) > 1e-6, 0.5 * (c0 - c2) / torch.clamp_min(denom, 1e-6),
                       0.0)
    frac = torch.clamp(frac, -1.0, 1.0)
    ur_new = (xr0 + bc.to(torch.int32) + frac).to(torch.float32) + w
    moved_ok = (torch.abs(ur_new - d.ur) <= r_search + 1.0) & (best == bc)
    ur = torch.where(d.valid & moved_ok, ur_new, d.ur)
    disp = torch.clamp_min(xy_l[:, 0] - ur, 1e-3)
    depth = torch.where(d.valid, fx * baseline / disp, 0.0)
    return StereoDepth(ur=torch.where(d.valid, ur, -1.0), depth=depth, valid=d.valid)
