"""Local mapping: new-point triangulation, point statistics and the local
BA window.

Counterpart of `orbslam3_tpu/pipeline/mapping.py` (parity target: the
reference LocalMapping stages, src/LocalMapping.cc: CreateNewMapPoints
:413-726 and the local BA dispatch :117-152).  The window BA runs the
grid solver with observations from the FeatureBank or the COO list, over
the covisibility window or the temporal one; `gather_window_problem` and
`gather_window_problem_bank` gather the COO problem that the COO bundle
adjuster (the post-loop full-map GBA among its callers) and the
visual-inertial BA solve, with the GNSS-constrained BA's position priors
when given.  The sharded BA is not ported yet and raises.

Tie rules kept from JAX: `lax.top_k` and `jnp.argsort` keep the lower
index first on ties, so the port sorts stably; `argmin` takes the first
minimum in both.  Scatters that can name one grid slot twice keep the last
row, as XLA does (`state._set_drop_last`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..features.extractor import FeatureFrame
from ..ops import cameras, lie, matching, triangulate
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _on, _row, _set_at, _set_drop, _set_drop_last
from ..solver import ba, ba_grid


def _scale_factors(scale_factor: float, n_levels: int, device) -> torch.Tensor:
    return scale_factor ** torch.arange(n_levels, dtype=torch.float32, device=device)


def _lv(octave, n_levels: int):
    return torch.clamp(octave, 0, n_levels - 1).long()


def fundamental_from_poses(R1, t1, R2, t2, K4):
    """F21 mapping image-1 points to epilines in image 2 (x2^T F21 x1 = 0)
    for a pinhole K (reference ORBmatcher ComputeF12)."""
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    E = lie.hat(t21) @ R21
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    Kinv = torch.stack([torch.stack([1.0 / fx, zero, -cx / fx]),
                        torch.stack([zero, 1.0 / fy, -cy / fy]),
                        torch.stack([zero, zero, one])])
    return Kinv.T @ E @ Kinv


class NewPoints(NamedTuple):
    xyz: torch.Tensor       # (N,3) world
    valid: torch.Tensor     # (N,) bool
    kp_cur: torch.Tensor    # (N,) keypoint index in the current frame
    kp_prev: torch.Tensor   # (N,) matched keypoint index in the other KF
    score: torch.Tensor     # (N,) cos(parallax), lower = wider baseline


def triangulate_new_points(ff_cur: FeatureFrame, ff_prev: FeatureFrame,
                           cur_unmatched, prev_unmatched,
                           R_cur, t_cur, R_prev, t_prev,
                           cam_model: str, cam_params, K4,
                           scale_factor: float = 1.2,
                           n_levels: int = 8) -> NewPoints:
    """Epipolar-gated matching of unmatched keypoints + DLT triangulation
    with the reference's acceptance gates (src/LocalMapping.cc:571-723):
    epipolar constraint (3.84 sigma2), parallax (cos < 0.9998), positive
    depth in both views, reprojection chi2 < 5.991 sigma2 in both views,
    and scale consistency between the two octaves (factor 1.5)."""
    sf = _scale_factors(scale_factor, n_levels, ff_cur.xy.device)
    sigma2 = sf ** 2
    if cam_model == cameras.PINHOLE:
        F_cp = fundamental_from_poses(R_cur, t_cur, R_prev, t_prev, K4)
        epi = matching.epipolar_mask(ff_cur.xy, ff_prev.xy, F_cp,
                                     sigma2[_lv(ff_prev.octave, n_levels)])
    else:
        # fisheye (KB8): the gate in ray space, not on distorted pixels (the
        # reference checks bearings, KannalaBrandt8.cpp:306): bearings on a
        # unit virtual pinhole (the z = 1 plane), the pixel sigma scaled by
        # the focal length
        b_c = cameras.unproject(cam_model, cam_params, ff_cur.xy)
        b_p = cameras.unproject(cam_model, cam_params, ff_prev.xy)
        n_c = b_c[:, :2] / torch.clamp_min(b_c[:, 2:3], 1e-3)
        n_p = b_p[:, :2] / torch.clamp_min(b_p[:, 2:3], 1e-3)
        F_cp = fundamental_from_poses(R_cur, t_cur, R_prev, t_prev,
                                      cameras.unit_pinhole(n_c.device))
        f_approx = cam_params[0]
        epi = matching.epipolar_mask(
            n_c, n_p, F_cp, sigma2[_lv(ff_prev.octave, n_levels)] / (f_approx * f_approx))
    mask = epi & cur_unmatched[:, None] & prev_unmatched[None, :] & \
        ff_cur.valid[:, None] & ff_prev.valid[None, :]
    mm = matching.match_nn(ff_cur.desc, ff_prev.desc, mask,
                           max_dist=matching.TH_LOW, nn_ratio=0.9,
                           angles_a=ff_cur.angle, angles_b=ff_prev.angle,
                           check_rotation=True)
    N = ff_cur.xy.shape[0]
    j = torch.clamp_min(mm.idx, 0).long()

    ray_c = cameras.unproject(cam_model, cam_params, ff_cur.xy)
    ray_p = cameras.unproject(cam_model, cam_params, ff_prev.xy[j])
    X = triangulate.triangulate_dlt(
        ray_c, ray_p, R_cur.expand(N, 3, 3), t_cur.expand(N, 3),
        R_prev.expand(N, 3, 3), t_prev.expand(N, 3))

    Xc = lie.se3_apply(R_cur, t_cur, X)
    Xp = lie.se3_apply(R_prev, t_prev, X)
    finite = torch.all(torch.isfinite(X), dim=-1)
    depth_ok = (Xc[:, 2] > 0) & (Xp[:, 2] > 0)
    # parallax between the rays in the world frame
    rc_w = ray_c @ R_cur
    rp_w = ray_p @ R_prev
    cosp = torch.sum(rc_w * rp_w, dim=-1) / (
        torch.linalg.norm(rc_w, dim=-1) * torch.linalg.norm(rp_w, dim=-1) + 1e-9)
    parallax_ok = cosp < 0.9998
    e_c = ff_cur.xy - cameras.project(cam_model, cam_params, Xc)
    e_p = ff_prev.xy[j] - cameras.project(cam_model, cam_params, Xp)
    s2c = sigma2[_lv(ff_cur.octave, n_levels)]
    s2p = sigma2[_lv(ff_prev.octave, n_levels)][j]
    reproj_ok = (torch.sum(e_c ** 2, -1) < 5.991 * s2c) & \
        (torch.sum(e_p ** 2, -1) < 5.991 * s2p)
    # scale consistency (reference: ratioDist vs ratioOctave within 1.5x)
    Oc = -(t_cur @ R_cur)
    Op = -(t_prev @ R_prev)
    d_c = torch.linalg.norm(X - Oc, dim=-1)
    d_p = torch.linalg.norm(X - Op, dim=-1)
    ratio_dist = d_p / torch.clamp_min(d_c, 1e-9)
    ratio_oct = sf[_lv(ff_cur.octave, n_levels)] / sf[_lv(ff_prev.octave, n_levels)][j]
    scale_ok = (ratio_dist < ratio_oct * 1.5) & (ratio_dist * 1.5 > ratio_oct)

    valid = mm.valid & finite & depth_ok & parallax_ok & reproj_ok & scale_ok
    return NewPoints(xyz=X, valid=valid,
                     kp_cur=torch.arange(N, dtype=torch.int32, device=X.device),
                     kp_prev=mm.idx, score=torch.where(valid, cosp, 2.0))


def _top_k(score: torch.Tensor, k: int):
    """lax.top_k: the k largest, lower index first on ties."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


def _prev_kf(m: mapstate.MapState, ki):
    """Largest valid keyframe index below ki, -1 if none."""
    ids = torch.arange(m.kf_R.shape[0], device=m.kf_R.device)
    before = (ids < ki) & m.kf_valid
    return torch.max(torch.where(before, ids, -1)), before, ids


def select_triangulation_neighbors(m: mapstate.MapState, ki, n_neighbors: int):
    """Triangulation partners for a new keyframe: the temporal predecessor
    plus the best covisible keyframes (reference CreateNewMapPoints,
    src/LocalMapping.cc:413-726).  Returns (idx (NN,), ok (NN,)); slot 0 is
    the temporal neighbour."""
    prev, before, ids = _prev_kf(m, ki)
    covis = mapstate.covisibility_weights(m, ki)
    score = torch.where(before & (ids != prev), covis, 0)
    vals, idxs = _top_k(score, n_neighbors - 1)
    idx = torch.cat([torch.clamp_min(prev, 0)[None], idxs])
    ok = torch.cat([(prev >= 0)[None], vals > 0])
    return idx, ok


def triangulate_vs_neighbors(m: mapstate.MapState, bank: fb.FeatureBank, ki,
                             ff: FeatureFrame, cur_unmatched, nbr_idx, nbr_ok,
                             cam_model: str, cam_params, K4,
                             scale_factor: float, n_levels: int) -> NewPoints:
    """Triangulate the current KF's unmatched keypoints against each
    neighbour keyframe (features from the FeatureBank), then keep per
    keypoint the neighbour with the widest parallax.  Returns NewPoints
    stacked over the NN neighbours; `valid` already lets each current
    keypoint create at most one point."""
    R_cur, t_cur = _row(m.kf_R, ki), _row(m.kf_t, ki)
    per_nbr = []
    for n in range(nbr_idx.shape[0]):
        nbr, ok = nbr_idx[n], nbr_ok[n]
        ffn = fb.frame_view(bank, nbr)
        unb = (_row(bank.kp_pt, nbr) < 0) & ffn.valid
        nps = triangulate_new_points(
            ff, ffn, cur_unmatched, unb, R_cur, t_cur, _row(m.kf_R, nbr), _row(m.kf_t, nbr),
            cam_model, cam_params, K4, scale_factor, n_levels)
        v = nps.valid & ok
        per_nbr.append(nps._replace(valid=v, score=torch.where(v, nps.score, 2.0)))
    nps = NewPoints(*(torch.stack(f) for f in zip(*per_nbr)))
    best = torch.argmin(nps.score, dim=0)          # (N,) winning neighbour
    NN = nbr_idx.shape[0]
    winner = (torch.arange(NN, device=best.device)[:, None] == best[None, :]) & nps.valid
    return nps._replace(valid=winner)


def point_descriptor_stats(X, desc, kf_center, octave, scale_factor: float,
                           n_levels: int):
    """Normal + scale range for freshly created points (reference
    MapPoint::UpdateNormalAndDepth, src/MapPoint.cc:440)."""
    sf = scale_factor ** torch.clamp(octave, 0, n_levels - 1).to(torch.float32)
    view = X - kf_center
    dist = torch.linalg.norm(view, dim=-1)
    normal = view / torch.clamp_min(dist, 1e-9)[:, None]
    max_dist = dist * sf
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    return normal, min_dist, max_dist


def _compact(mask: torch.Tensor, cap: int, score=None):
    """Select up to `cap` True positions: returns (sel (cap,), sel_valid
    (cap,), inv (n,) mapping global -> local or -1).  With `score`, True
    positions are taken best-score-first (the reference's sorted point
    budget, src/Optimizer.cc:4277-4295); ties keep index order."""
    n = mask.shape[0]
    dev = mask.device
    if score is None:
        order = torch.argsort((~mask).to(torch.int32), stable=True)
    else:
        order = torch.argsort(torch.where(mask, -score.to(torch.float32),
                                          float("inf")), stable=True)
    sel = order[:cap]
    if cap > n:
        # the candidate pool is smaller than the capacity: pad with index 0,
        # masked by sel_valid
        sel = torch.nn.functional.pad(sel, (0, cap - n))
    count = torch.sum(mask.to(torch.int32))
    sel_valid = torch.arange(cap, device=dev) < count
    inv = _set_drop(torch.full((n,), -1, dtype=torch.int32, device=dev),
                    torch.where(sel_valid, sel, n),
                    torch.arange(cap, dtype=torch.int32, device=dev))
    return sel, sel_valid, inv


def _window(m: mapstate.MapState, center_kf, window: int, window_mode: str):
    """The free BA window.  "covis": the center KF, its top `window - 1`
    covisible KFs and the temporal predecessor; "temporal": the `window`
    KFs up to the center (LocalInertialBA keeps the chain of preintegration
    factors inside the free window, reference src/Optimizer.cc:2452-2460).
    Returns (in_window (K,) bool, win_idx): the indices that the grid
    bank's point budget projects into."""
    center = center_kf
    if window_mode == "temporal":
        K = m.kf_R.shape[0]
        ids = torch.arange(K, device=m.kf_R.device)
        in_window = (ids > center - window) & (ids <= center) & m.kf_valid
        return in_window, torch.clamp(center - torch.arange(window, device=ids.device), 0, K - 1)
    if window_mode != "covis":
        raise ValueError(f"window_mode {window_mode!r}")
    prev, _, ids = _prev_kf(m, center)
    covis = mapstate.covisibility_weights(m, center)
    cscore = torch.where(m.kf_valid & (ids != center), covis, 0)
    top_vals, top_idx = _top_k(cscore, max(window - 1, 1))
    in_window = torch.zeros_like(m.kf_valid)
    in_window[top_idx] = top_vals > 0
    in_window = _set_at(in_window, center, True)
    p0 = torch.clamp_min(prev, 0)
    in_window = _set_at(in_window, p0, _row(in_window, p0) | (prev >= 0))
    c = _on(center, torch.int64, ids.device)
    return in_window & m.kf_valid, torch.cat([c[None], p0[None], top_idx])


def _anchors(in_window, cam_sel, cam_sel_valid, min_anchors: int):
    """Gauge: KF0 and every camera outside the window are fixed; with
    >= 3 cameras and fewer than `min_anchors` fixed ones, KF1 is pinned
    too (the monocular scale gauge)."""
    fixed = ~in_window[cam_sel] | (cam_sel < 1)
    n_prob_cams = torch.sum(cam_sel_valid.to(torch.int32))
    n_anchors = torch.sum((fixed & cam_sel_valid).to(torch.int32))
    need_second = (n_anchors < min_anchors) & (n_prob_cams >= 3)
    return fixed | ((cam_sel == 1) & need_second)


def _grid_problem(m, in_window, cam_sel, cam_sel_valid, pt_sel, pt_sel_valid,
                  grid, min_anchors):
    has = grid[:, :, 4] > 0
    return ba_grid.GridBAProblem(
        R=m.kf_R[cam_sel], t=m.kf_t[cam_sel],
        cam_fixed=_anchors(in_window, cam_sel, cam_sel_valid, min_anchors),
        cam_valid=cam_sel_valid,
        X=m.pt_xyz[pt_sel], pt_valid=pt_sel_valid & m.pt_valid[pt_sel],
        uv=grid[:, :, 0:2], inv_sigma2=grid[:, :, 2], valid=has,
        ur=torch.where(has, grid[:, :, 3], -1.0))


def _scatter_grid(cap_pts: int, cap_cams: int, gp, gk, ok, payload):
    """(cap_pts, cap_cams, 5) grid of [u, v, inv_sigma2, ur, flag] rows at
    (gp, gk) where ok; a slot named twice keeps the last row (T13)."""
    n = cap_pts * cap_cams
    flat = torch.where(ok, gp.long() * cap_cams + gk.long(), n)
    grid = torch.zeros((n, 5), dtype=torch.float32, device=payload.device)
    return _set_drop_last(grid, flat.reshape(-1), payload.reshape(-1, 5)).reshape(
        cap_pts, cap_cams, 5)


def gather_window_grid(m: mapstate.MapState, center_kf, window: int,
                       n_levels: int, scale_factor: float,
                       cap_cams: int = 16, cap_pts: int = 4096,
                       window_mode: str = "covis", min_anchors: int = 2):
    """Window selection into the dense (cap_pts, cap_cams) observation grid
    from the COO observation list (reference LocalBundleAdjustment window,
    src/Optimizer.cc:1069-1140): points budgeted by in-window observation
    count, in-window cameras first, then the best-connected anchors.
    Returns (GridBAProblem, cam_sel, cam_sel_valid, pt_sel, pt_valid)."""
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    sf = _scale_factors(scale_factor, n_levels, dev)
    in_window, _ = _window(m, center_kf, window, window_mode)

    obs_pt_c = torch.clamp(m.obs_pt, 0, P - 1).long()
    obs_kf_c = torch.clamp(m.obs_kf, 0, K - 1).long()
    obs_ok = m.obs_valid & m.pt_valid[obs_pt_c] & m.kf_valid[obs_kf_c]
    i32 = torch.int32

    # in-window observation count per point: selection flag and budget score
    nobs_win = torch.zeros(P, dtype=i32, device=dev).index_add(
        0, obs_pt_c, (obs_ok & in_window[obs_kf_c]).to(i32))
    pt_sel, pt_sel_valid, pt_inv = _compact(nobs_win > 0, cap_pts, score=nobs_win)

    obs_rel = obs_ok & (pt_inv[obs_pt_c] >= 0)
    cam_nobs = torch.zeros(K, dtype=i32, device=dev).index_add(
        0, obs_kf_c, obs_rel.to(i32))
    cam_touched = (cam_nobs > 0) | in_window
    cam_score = cam_nobs.to(torch.float32) + torch.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, cam_inv = _compact(cam_touched, cap_cams, score=cam_score)

    gp = pt_inv[obs_pt_c]
    gk = cam_inv[obs_kf_c]
    ok = obs_rel & (gk >= 0)
    inv_sigma2 = 1.0 / sf[_lv(m.obs_octave, n_levels)] ** 2
    payload = torch.cat([m.obs_uv, inv_sigma2[:, None], m.obs_ur[:, None],
                         torch.ones_like(inv_sigma2)[:, None]], dim=1)
    grid = _scatter_grid(cap_pts, cap_cams, gp, torch.clamp_min(gk, 0), ok, payload)
    prob = _grid_problem(m, in_window, cam_sel, cam_sel_valid, pt_sel,
                         pt_sel_valid, grid, min_anchors)
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def gather_window_grid_bank(m: mapstate.MapState, bank: fb.FeatureBank, center_kf,
                            window: int, n_levels: int, scale_factor: float,
                            cam_model: str = "pinhole", cam_params=None,
                            cap_cams: int = 16, cap_pts: int = 4096,
                            window_mode: str = "covis", min_anchors: int = 2):
    """Window selection into the dense grid, with observations from the
    selected cameras' FeatureBank rows instead of the map-capacity COO
    list.  Same window and anchor semantics as `gather_window_grid`; when
    the point cap binds, points are taken lowest current reprojection
    error first (reference KeyFrame::GetSortedReprojectionErrorIndices,
    src/KeyFrame.cc:424)."""
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    sf = _scale_factors(scale_factor, n_levels, dev)
    in_window, win_idx = _window(m, center_kf, window, window_mode)

    # point candidates: in-window observer count (one incidence matvec)
    live = mapstate.live_incidence(m).to(torch.float32)
    nobs_win = live @ in_window.to(torch.float32)
    # budget order: each point's smallest reprojection error over the
    # window KFs' bank rows, BIG where no row sees it
    win_ok = in_window[win_idx]
    wpt = bank.kp_pt[win_idx]                                 # (W, N)
    wpt_c = torch.clamp(wpt, 0, P - 1).long()
    Xc = torch.einsum("wab,wnb->wna", m.kf_R[win_idx], m.pt_xyz[wpt_c]) + \
        m.kf_t[win_idx][:, None]
    uvp = cameras.project(cam_model, cam_params, Xc.reshape(-1, 3)).reshape(
        Xc.shape[0], Xc.shape[1], 2)
    err = torch.linalg.norm(bank.xy[win_idx] - uvp, dim=-1)
    row_ok = bank.valid[win_idx] & (wpt >= 0) & m.pt_valid[wpt_c] & \
        win_ok[:, None] & (Xc[..., 2] > 1e-3)
    BIG = 1e6
    pt_err = torch.full((P + 1,), BIG, dtype=torch.float32, device=dev).scatter_reduce(
        0, torch.where(row_ok, wpt_c, P).reshape(-1),
        torch.clamp_max(err, BIG - 1.0).reshape(-1), "amin", include_self=True)[:P]
    pt_sel, pt_sel_valid, pt_inv = _compact(nobs_win > 0, cap_pts, score=-pt_err)

    # cameras: window KFs free, out-of-window observers of the selected
    # points as fixed anchors (one incidence matvec)
    sel_mask = _set_drop(torch.zeros(P, dtype=torch.float32, device=dev),
                         torch.where(pt_sel_valid, pt_sel, P), 1.0)
    cam_obs_sel = sel_mask @ live
    cam_touched = ((cam_obs_sel > 0) | in_window) & m.kf_valid
    cam_score = cam_obs_sel + torch.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, _ = _compact(cam_touched, cap_cams, score=cam_score)

    # observations: the selected cameras' bank rows, (C, N) in all
    kpt = bank.kp_pt[cam_sel]
    kpt_c = torch.clamp(kpt, 0, P - 1).long()
    gp = pt_inv[kpt_c]
    ok = bank.valid[cam_sel] & (kpt >= 0) & m.pt_valid[kpt_c] & (gp >= 0) & \
        cam_sel_valid[:, None]
    inv_sigma2 = 1.0 / sf[_lv(bank.octave[cam_sel], n_levels)] ** 2
    payload = torch.cat([bank.xy[cam_sel], inv_sigma2[..., None],
                         bank.ur[cam_sel][..., None],
                         torch.ones_like(inv_sigma2)[..., None]], dim=-1)
    C = cam_sel.shape[0]
    gk = torch.arange(C, device=dev)[:, None].expand(ok.shape)
    grid = _scatter_grid(cap_pts, cap_cams, gp, gk, ok, payload)
    prob = _grid_problem(m, in_window, cam_sel, cam_sel_valid, pt_sel,
                         pt_sel_valid, grid, min_anchors)
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def gather_window_problem(m: mapstate.MapState, center_kf, window: int, n_levels: int,
                          scale_factor: float, cap_cams: int = 32, cap_pts: int = 8192,
                          cap_obs: int = 32768, window_mode: str = "covis",
                          min_anchors: int = 2, prior_pos=None, prior_w=None):
    """The window problem as COO observations from the map's observation
    list (reference LocalBundleAdjustment window, src/Optimizer.cc:1069-1140):
    the points the window observes, budgeted by their observation count;
    every observer of those points, in-window cameras first (free), the
    best-connected others after them (fixed anchors); their observations
    compacted to `cap_obs`.  `prior_pos` (K, 3) and `prior_w` (K,), per
    keyframe, become the selected cameras' position priors.  Returns
    (BAProblem, cam_sel, cam_sel_valid, pt_sel, pt_valid)."""
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    i32 = torch.int32
    sf = _scale_factors(scale_factor, n_levels, dev)
    in_window, _ = _window(m, center_kf, window, window_mode)

    obs_pt_c = torch.clamp(m.obs_pt, 0, P - 1).long()
    obs_kf_c = torch.clamp(m.obs_kf, 0, K - 1).long()
    obs_ok = m.obs_valid & m.pt_valid[obs_pt_c] & m.kf_valid[obs_kf_c]
    # points observed by the window, budgeted by observation count
    pt_in = torch.zeros(P, dtype=i32, device=dev).index_add_(
        0, obs_pt_c, (obs_ok & in_window[obs_kf_c]).to(i32)) > 0
    nobs = torch.zeros(P, dtype=i32, device=dev).index_add_(0, obs_pt_c, obs_ok.to(i32))
    pt_sel, pt_sel_valid, pt_inv = _compact(pt_in, cap_pts, score=nobs)

    # observations of those points from any keyframe; in-window cameras
    # survive the capacity cut, then the best-connected anchors
    obs_rel = obs_ok & (pt_inv[obs_pt_c] >= 0)
    cam_nobs = torch.zeros(K, dtype=i32, device=dev).index_add_(0, obs_kf_c, obs_rel.to(i32))
    cam_touched = (cam_nobs > 0) | in_window
    cam_score = cam_nobs.to(torch.float32) + torch.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, cam_inv = _compact(cam_touched, cap_cams, score=cam_score)
    obs_rel = obs_rel & (cam_inv[obs_kf_c] >= 0)
    obs_sel, obs_sel_valid, _ = _compact(obs_rel, cap_obs)

    o_kf = cam_inv[obs_kf_c[obs_sel]]
    o_pt = pt_inv[obs_pt_c[obs_sel]]
    inv_sigma2 = 1.0 / sf[_lv(m.obs_octave[obs_sel], n_levels)] ** 2
    prob = ba.BAProblem(
        R=m.kf_R[cam_sel], t=m.kf_t[cam_sel],
        cam_fixed=_anchors(in_window, cam_sel, cam_sel_valid, min_anchors),
        cam_valid=cam_sel_valid,
        X=m.pt_xyz[pt_sel], pt_valid=pt_sel_valid & m.pt_valid[pt_sel],
        obs_cam=torch.clamp_min(o_kf, 0), obs_pt=torch.clamp_min(o_pt, 0),
        obs_uv=m.obs_uv[obs_sel], obs_inv_sigma2=inv_sigma2,
        obs_valid=obs_sel_valid & (o_kf >= 0) & (o_pt >= 0),
        obs_ur=m.obs_ur[obs_sel])
    prob = _with_priors(prob, cam_sel, prior_pos, prior_w)
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def gather_window_problem_bank(m: mapstate.MapState, bank: fb.FeatureBank, center_kf,
                               window: int, n_levels: int, scale_factor: float,
                               cap_cams: int = 32, cap_pts: int = 8192, cap_obs: int = 32768,
                               window_mode: str = "covis", min_anchors: int = 2,
                               prior_pos=None, prior_w=None):
    """The window problem as COO observations from the selected cameras'
    FeatureBank rows (the solvers that take an observation list, the
    visual-inertial BA among them).  Points are budgeted by their in-window
    observer count, in-window cameras come first and the best-connected
    out-of-window observers fill the rest as fixed anchors; the rows are
    compacted to `cap_obs`; position priors as in `gather_window_problem`.
    Returns (BAProblem, cam_sel, cam_sel_valid, pt_sel, pt_valid)."""
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    sf = _scale_factors(scale_factor, n_levels, dev)
    in_window, _ = _window(m, center_kf, window, window_mode)

    live = mapstate.live_incidence(m).to(torch.float32)
    nobs_win = live @ in_window.to(torch.float32)
    pt_sel, pt_sel_valid, pt_inv = _compact(nobs_win > 0, cap_pts, score=nobs_win)

    sel_mask = _set_drop(torch.zeros(P, dtype=torch.float32, device=dev),
                         torch.where(pt_sel_valid, pt_sel, P), 1.0)
    cam_obs_sel = sel_mask @ live
    cam_touched = ((cam_obs_sel > 0) | in_window) & m.kf_valid
    cam_score = cam_obs_sel + torch.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, _ = _compact(cam_touched, cap_cams, score=cam_score)

    # observation rows: the selected cameras' bank rows, compacted to cap_obs
    C = cam_sel.shape[0]
    kpt = bank.kp_pt[cam_sel]                                  # (C, N)
    kpt_c = torch.clamp(kpt, 0, P - 1).long()
    gp = pt_inv[kpt_c]
    ok = (bank.valid[cam_sel] & (kpt >= 0) & m.pt_valid[kpt_c] & (gp >= 0) &
          cam_sel_valid[:, None]).reshape(-1)
    obs_sel, obs_sel_valid, _ = _compact(ok, cap_obs)
    o_kf = torch.arange(C, device=dev)[:, None].expand(kpt.shape).reshape(-1)[obs_sel]
    o_pt = gp.reshape(-1)[obs_sel]
    inv_sigma2 = 1.0 / sf[_lv(bank.octave[cam_sel].reshape(-1)[obs_sel], n_levels)] ** 2
    prob = ba.BAProblem(
        R=m.kf_R[cam_sel], t=m.kf_t[cam_sel],
        cam_fixed=_anchors(in_window, cam_sel, cam_sel_valid, min_anchors),
        cam_valid=cam_sel_valid,
        X=m.pt_xyz[pt_sel], pt_valid=pt_sel_valid & m.pt_valid[pt_sel],
        obs_cam=o_kf.to(torch.int32), obs_pt=torch.clamp_min(o_pt, 0),
        obs_uv=bank.xy[cam_sel].reshape(-1, 2)[obs_sel], obs_inv_sigma2=inv_sigma2,
        obs_valid=obs_sel_valid & (o_pt >= 0),
        obs_ur=bank.ur[cam_sel].reshape(-1)[obs_sel])
    prob = _with_priors(prob, cam_sel, prior_pos, prior_w)
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def _with_priors(prob: ba.BAProblem, cam_sel, prior_pos, prior_w) -> ba.BAProblem:
    """The selected cameras' rows of the per-keyframe position priors."""
    if prior_pos is None:
        return prob
    return prob._replace(prior_pos=prior_pos[cam_sel], prior_w=prior_w[cam_sel])


def run_local_ba(m: mapstate.MapState, center_kf, cam_model: str, cam_params,
                 window: int = 8, iterations: int = 10, scale_factor: float = 1.2,
                 n_levels: int = 8, chi2_cull: float = 7.5, stereo_bf: float = 0.0,
                 mesh=None, mesh_axis: str = "shard", prior_pos=None, prior_w=None,
                 pcg_iters: int = 32, schur_solver: str = "auto", bank=None, **caps):
    """Local BA on a keyframe window (reference LocalBundleAdjustment):
    gather the window, solve, and write the free cameras and the window
    points back.  `caps`: cap_cams, cap_pts, cap_obs and window_mode
    ("covis" or "temporal"), as in the JAX package.

    Window-sized problems (no mesh, no priors, at most 32 cameras) go to the
    grid solver, whose gather is always the covisibility window, as in JAX;
    the others (`schur_solver` "pcg" or "dense") to the COO bundle adjuster,
    gathered from the feature bank when one is given, else from the map's
    observation list.  With `mesh` (`parallel.multihost.Mesh`) the COO
    problem is partitioned over its shards and solved by
    `parallel.dist_ba.dist_bundle_adjust` with its defaults, as in JAX: its
    own PCG steps (`pcg_iters` is not passed) and no stereo rows
    (`stereo_bf` is not passed, so stereo observations count as monocular).
    Where JAX partitions the window's points as the gather leaves them, all
    in the first slots, the port first deals them over the shards, so that
    no shard overflows and every observation stays in the solve.
    `prior_pos` (K, 3) and `prior_w` (K,) are per-keyframe camera-centre
    priors and their information (0: none), the GNSS BA's
    (`System._gnss_keyframe_stage`); a problem with them goes to the COO
    solver.  `chi2_cull` is accepted only for parity with the JAX signature
    and is not read (unused in JAX too)."""
    cap_cams = caps.get("cap_cams", 32)
    window_mode = caps.pop("window_mode", "covis")
    if schur_solver == "auto":
        schur_solver = "grid" if mesh is None and prior_pos is None and cap_cams <= 32 else "pcg"
    if schur_solver == "grid":
        cap_pts = caps.get("cap_pts", 8192)
        if bank is not None:
            prob, cam_sel, cam_ok, pt_sel, pt_ok = gather_window_grid_bank(
                m, bank, center_kf, window, n_levels, scale_factor,
                cam_model=cam_model, cam_params=cam_params,
                cap_cams=cap_cams, cap_pts=cap_pts)
        else:
            prob, cam_sel, cam_ok, pt_sel, pt_ok = gather_window_grid(
                m, center_kf, window, n_levels, scale_factor,
                cap_cams=cap_cams, cap_pts=cap_pts)
        R, t, X, _ = ba_grid.bundle_adjust_grid(prob, cam_model, cam_params,
                                                iterations=iterations, stereo_bf=stereo_bf)
    else:
        if bank is not None:
            prob, cam_sel, cam_ok, pt_sel, pt_ok = gather_window_problem_bank(
                m, bank, center_kf, window, n_levels, scale_factor,
                window_mode=window_mode, prior_pos=prior_pos, prior_w=prior_w, **caps)
        else:
            prob, cam_sel, cam_ok, pt_sel, pt_ok = gather_window_problem(
                m, center_kf, window, n_levels, scale_factor, window_mode=window_mode,
                prior_pos=prior_pos, prior_w=prior_w, **caps)
        if mesh is not None:
            from ..parallel import dist_ba
            n = mesh.shape[mesh_axis]
            # the gather compacts the window's points into the first slots,
            # so the first shards would own them all and drop what overflows
            # their observation slots (JAX drops a third of the rows); deal
            # the slots over the shards instead: slot i -> shard i mod n
            P_cap = prob.X.shape[0]
            ar = torch.arange(P_cap, device=prob.X.device)
            deal = (ar % n) * (P_cap // n) + ar // n
            back = torch.argsort(deal)
            dealt = prob._replace(X=prob.X[back], pt_valid=prob.pt_valid[back],
                                  obs_pt=deal[prob.obs_pt.long()].to(prob.obs_pt.dtype))
            R, t, X, _ = dist_ba.dist_bundle_adjust(
                dist_ba.partition_problem(dealt, n), mesh, axis=mesh_axis, cam_model=cam_model,
                cam_params=cam_params, iterations=iterations)
            X = X[deal]
        else:
            res = ba.bundle_adjust(prob, cam_model, cam_params, iterations=iterations,
                                   stereo_bf=stereo_bf, pcg_iters=pcg_iters,
                                   schur_solver=schur_solver)
            R, t, X = res.R, res.t, res.X
    # scatter back the free cameras and the window points
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    free = cam_ok & ~prob.cam_fixed
    return m._replace(
        kf_R=_set_drop(m.kf_R, torch.where(free, cam_sel, K), R),
        kf_t=_set_drop(m.kf_t, torch.where(free, cam_sel, K), t),
        pt_xyz=_set_drop(m.pt_xyz, torch.where(pt_ok, pt_sel, P), X))
