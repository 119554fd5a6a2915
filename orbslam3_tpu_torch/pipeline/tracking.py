"""Per-frame tracking against the local map.

Counterpart of `orbslam3_tpu/pipeline/tracking.py` (parity target: the
reference's monocular Tracking, src/Tracking.cc): project the local-map
points into the predicted pose, gate by the SearchByProjection windows
(src/ORBmatcher.cc:31-124), match by masked Hamming NN, then pose-only
optimization (src/Optimizer.cc:765).  Everything stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..features.extractor import FeatureFrame
from ..ops import cameras, lie, matching
from ..slam_map import state as mapstate
from ..slam_map.state import _set_drop
from ..solver import pose_opt
from ..utils import profiling


class TrackResult(NamedTuple):
    R: torch.Tensor          # optimized R_cw
    t: torch.Tensor
    n_matches: torch.Tensor  # () matches fed to the optimizer
    n_inliers: torch.Tensor  # () inliers after optimization
    kp_pt: torch.Tensor      # (N,) int32 map-point index per keypoint (-1 none)
    kp_inlier: torch.Tensor  # (N,) bool
    pt_matched: torch.Tensor  # (P,) bool: map points matched this frame
    pt_visible: torch.Tensor  # (P,) bool: map points predicted visible


def predict_scale(dist, max_dist, scale_factor: float, n_levels: int):
    """MapPoint::PredictScale (reference src/MapPoint.cc:555).  The level
    is clamped while still a float: XLA's float->int32 conversion
    saturates (inf -> INT_MAX), torch's does not."""
    ratio = max_dist / torch.clamp_min(dist, 1e-6)
    log_sf = torch.log(torch.full((), scale_factor, device=ratio.device))
    lv = torch.ceil(torch.log(ratio) / log_sf)
    return torch.clamp(lv, 0, n_levels - 1).to(torch.int32)


def track_local_map(m: mapstate.MapState, ff: FeatureFrame,
                    R_guess, t_guess, cam_model: str, cam_params,
                    image_hw: tuple[int, int],
                    scale_factor: float = 1.2, n_levels: int = 8,
                    radius_th=4.0,
                    nn_ratio: float = 0.8,
                    view: mapstate.PointView | None = None) -> TrackResult:
    """Project the local map points into the predicted frame, match by
    projection gates, then pose-only optimize.

    `view` is the local map (state.gather_local_view); `view=None` tracks
    against the whole capacity.  Returned indices (`kp_pt`) and per-point
    flags (`pt_matched`/`pt_visible`) are always global point slots.
    """
    with profiling.span("track_local_map"):
        h, w = image_hw
        dev = ff.xy.device
        sf = scale_factor ** torch.arange(n_levels, dtype=torch.float32, device=dev)
        P = m.pt_xyz.shape[0]
        v = view if view is not None else mapstate.full_view(m)

        with profiling.span("project_match"):
            Xc = lie.se3_apply(R_guess, t_guess, v.xyz)
            uv = cameras.project(cam_model, cam_params, Xc)
            depth = Xc[..., 2]
            dist = torch.linalg.norm(Xc, dim=-1)
            # viewing angle: cos(normal, view dir from camera center) > 0.5
            Ow = -(R_guess.T @ t_guess)
            vdir = v.xyz - Ow
            vdir = vdir / (torch.linalg.norm(vdir, dim=-1, keepdim=True) + 1e-9)
            cos_view = torch.sum(vdir * v.normal, dim=-1)
            has_normal = torch.linalg.norm(v.normal, dim=-1) > 1e-6
            in_img = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
            dist_ok = (dist >= 0.8 * v.min_dist) & (dist <= 1.2 * v.max_dist)
            visible = v.valid & (depth > 0) & in_img & dist_ok & \
                (~has_normal | (cos_view > 0.5))

            pred_oct = predict_scale(dist, v.max_dist, scale_factor, n_levels)
            mask = matching.projection_mask(uv, pred_oct, visible, ff.xy, ff.octave,
                                            ff.valid, sf, radius_th)
            mm = matching.match_nn(v.desc, ff.desc, mask,
                                   max_dist=matching.TH_HIGH, nn_ratio=nn_ratio)
        # mm.idx: keypoint index per view slot
        V = v.xyz.shape[0]
        N = ff.xy.shape[0]
        kp_pt = _set_drop(torch.full((N,), -1, dtype=torch.int32, device=dev),
                          torch.where(mm.valid, mm.idx, N),
                          torch.arange(V, dtype=torch.int32, device=dev))
        matched_kp = kp_pt >= 0
        kp_c = torch.clamp(kp_pt, 0, V - 1).long()

        inv_sigma2 = 1.0 / sf[torch.clamp(ff.octave, 0, n_levels - 1).long()] ** 2
        with profiling.span("pose_opt"):
            res = pose_opt.pose_optimization(
                R_guess, t_guess, v.xyz[kp_c], ff.xy, inv_sigma2,
                matched_kp & ff.valid, cam_model, cam_params)

        # globalize: view slots -> global point slots
        kp_pt_g = torch.where(matched_kp, v.idx[kp_c], -1)
        no_pt = torch.zeros(P, dtype=torch.bool, device=dev)
        if view is None:
            pt_matched = _set_drop(no_pt, torch.where(
                mm.valid, torch.arange(P, device=dev), P), True)
            pt_visible = visible
        else:
            pt_matched = _set_drop(no_pt, torch.where(
                mm.valid & (v.idx >= 0), v.idx, P), True)
            pt_visible = _set_drop(no_pt, torch.where(
                visible & (v.idx >= 0), v.idx, P), True)
        return TrackResult(
            R=res.R, t=res.t,
            n_matches=torch.sum(matched_kp.to(torch.int32)),
            n_inliers=res.n_inliers,
            kp_pt=torch.where(res.inliers, kp_pt_g, -1),
            kp_inlier=res.inliers,
            pt_matched=pt_matched,
            pt_visible=pt_visible)


def update_point_stats(m: mapstate.MapState, tr: TrackResult) -> mapstate.MapState:
    """Increase Visible/Found counters (reference MapPoint::IncreaseVisible/
    IncreaseFound via Tracking::SearchLocalPoints)."""
    return m._replace(
        pt_visible=m.pt_visible + tr.pt_visible.to(torch.int32),
        pt_found=m.pt_found + tr.pt_matched.to(torch.int32))
