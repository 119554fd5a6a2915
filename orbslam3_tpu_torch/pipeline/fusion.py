"""Map maintenance: duplicate-point fusion, keyframe culling and the
representative-descriptor refresh.

Counterpart of `orbslam3_tpu/pipeline/fusion.py`.  Parity targets:
ORBmatcher::Fuse (src/ORBmatcher.cc:678) and SearchInNeighbors
(src/LocalMapping.cc:764) for `fuse_into_keyframe`; KeyFrameCulling
(src/LocalMapping.cc:902) for the redundancy check and `cull_keyframe`;
MapPoint::ComputeDistinctiveDescriptors (src/MapPoint.cc:343) for
`refresh_point_descriptors`.

Fusion can bind one point to a second keypoint of the same keyframe, so
the scatters keyed by point keep the last row, as XLA does (T13); the
predicted octave is clamped while still a float (T11, `pt_max_dist` is
inf on empty slots).
"""

from __future__ import annotations

import torch

from ..ops import cameras, lie, matching
from ..slam_map import state as mapstate
from ..slam_map.state import _row, _set_drop, _set_drop_last
from .tracking import predict_scale


def fuse_into_keyframe(m: mapstate.MapState, kf_idx, ff, kp_pt,
                       cam_model: str, cam_params, image_hw,
                       scale_factor: float = 1.2, n_levels: int = 8,
                       radius_th: float = 3.0):
    """Fuse map points into one keyframe's features.

    Every valid map point projected into KF `kf_idx` is matched to the
    best keypoint in its radius and scale window.  An unbound keypoint is
    bound (a new observation); one bound to a different point is merged:
    the point with more observations wins and the other is invalidated.
    Returns (map, kp_pt updated, n_fused)."""
    h, w = image_hw
    P = m.pt_xyz.shape[0]
    N = ff.xy.shape[0]
    dev = m.pt_xyz.device
    sf = scale_factor ** torch.arange(n_levels, dtype=torch.float32, device=dev)
    Xc = lie.se3_apply(_row(m.kf_R, kf_idx), _row(m.kf_t, kf_idx), m.pt_xyz)
    uv = cameras.project(cam_model, cam_params, Xc)
    dist = torch.linalg.norm(Xc, dim=-1)
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    dist_ok = (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.2 * m.pt_max_dist)
    visible = m.pt_valid & (Xc[..., 2] > 0) & in_img & dist_ok

    pred_oct = predict_scale(dist, m.pt_max_dist, scale_factor, n_levels)
    mask = matching.projection_mask(uv, pred_oct, visible, ff.xy, ff.octave,
                                    ff.valid, sf, radius_th)
    mm = matching.match_nn(m.pt_desc, ff.desc, mask, max_dist=matching.TH_LOW)
    # per map point: the matched keypoint j (or -1) and its current binding
    jc = torch.clamp_min(mm.idx, 0).long()
    existing = kp_pt[jc]
    pts = torch.arange(P, dtype=torch.int32, device=dev)
    is_new_obs = mm.valid & (existing < 0)
    is_conflict = mm.valid & (existing >= 0) & (existing != pts)

    # observation counts decide the merge direction
    nobs = mapstate.point_obs_count(m)
    other = torch.clamp(existing, 0, P - 1).long()
    i_wins = nobs >= nobs[other]
    lose_other_pt = torch.where(is_conflict & i_wins, other, P)
    pt_valid = m.pt_valid & ~(is_conflict & ~i_wins)
    # pt_valid.at[clip(lose_other_pt)].set(...): every row writes, rows
    # without a loser write back the current value, the last row wins
    lo_c = torch.clamp(lose_other_pt, 0, P - 1)
    pt_valid = _set_drop_last(pt_valid, lo_c,
                              torch.where(lose_other_pt < P, False, pt_valid[lo_c]))

    # bind the new observations (one point per keypoint: match_nn resolved
    # duplicate targets)
    winners = is_new_obs | (is_conflict & i_wins)
    kp_pt2 = _set_drop(kp_pt, torch.where(winners, jc, N), pts)
    m2 = mapstate.add_observations(
        m._replace(pt_valid=pt_valid), kf_idx, torch.where(winners, pts, -1),
        ff.xy[jc], ff.octave[jc], winners)
    return m2, kp_pt2, torch.sum(is_conflict.to(torch.int32))


def _seen_and_total(m: mapstate.MapState):
    """(P, K) bool: keyframe k has a live observation of point p; (P,)
    int32: live observations of each point (COO rows, duplicates count)."""
    P, K = m.pt_kf_mask.shape
    obs_pt_c = torch.clamp(m.obs_pt, 0, P - 1).long()
    ok = m.obs_valid & m.pt_valid[obs_pt_c]
    tot = torch.zeros(P, dtype=torch.int32, device=ok.device).index_add(
        0, obs_pt_c, ok.to(torch.int32))
    seen = torch.zeros((P + 1, K), dtype=torch.bool, device=ok.device)
    seen.index_put_((torch.where(ok & (m.obs_kf >= 0), obs_pt_c, P),
                     torch.clamp(m.obs_kf, 0, K - 1).long()), ok)
    return seen[:P], tot


def _redundancy(seen, tot, redundant_th: float, min_other_obs: int):
    """Per keyframe column of `seen`: (is_redundant, fraction of its points
    observed at least `min_other_obs` times elsewhere)."""
    n_mine = torch.sum(seen.to(torch.int32), dim=0)
    n_red = torch.sum((seen & (tot - 1 >= min_other_obs)[:, None]).to(torch.int32), dim=0)
    frac = n_red.to(torch.float32) / torch.clamp_min(n_mine.to(torch.float32), 1.0)
    return (frac >= redundant_th) & (n_mine > 0), frac


def keyframe_redundancy(m: mapstate.MapState, kf_idx,
                        redundant_th: float = 0.9, min_other_obs: int = 3):
    """KeyFrameCulling check for one keyframe: the fraction of its observed
    points that >= 3 other keyframes also observe.  Returns
    (is_redundant, fraction)."""
    seen, tot = _seen_and_total(m)
    red, frac = _redundancy(_row(seen, kf_idx, dim=1)[:, None], tot, redundant_th,
                            min_other_obs)
    return red[0], frac[0]


def redundancy_window(m: mapstate.MapState, center_kf, window: int = 8,
                      protect_recent: int = 3, redundant_th: float = 0.9,
                      min_other_obs: int = 3):
    """Redundancy flags (K,) bool for the KFs in (center - window,
    center - protect_recent]; KF0 and KF1 are never candidates.  One
    per-point total and one (P, K) seen-by mask give every keyframe's
    check at once."""
    K = m.kf_R.shape[0]
    ids = torch.arange(K, device=m.kf_R.device)
    cand = (ids > torch.clamp_min(torch.as_tensor(center_kf) - window, 1)) & \
        (ids <= center_kf - protect_recent) & m.kf_valid
    seen, tot = _seen_and_total(m)
    flags, _ = _redundancy(seen, tot, redundant_th, min_other_obs)
    return flags & cand


def cull_keyframe(m: mapstate.MapState, kf_idx) -> mapstate.MapState:
    """Remove a redundant keyframe: invalidate it and its observations
    (reference KeyFrame::SetBadFlag, src/KeyFrame.cc:652)."""
    return m._replace(kf_valid=mapstate._set_at(m.kf_valid, kf_idx, False),
                      obs_valid=m.obs_valid & ~(m.obs_kf == kf_idx))


def refresh_point_descriptors(m: mapstate.MapState, ff, kp_pt) -> mapstate.MapState:
    """ComputeDistinctiveDescriptors: push the keyframe's descriptor into
    each bound point's ring reservoir (`pt_desc_hist`, slot = count % M),
    then make the point's descriptor the reservoir entry with the smallest
    median Hamming distance to the others (the self-distance 0 counts, as
    in the reference)."""
    P = m.pt_xyz.shape[0]
    M = m.pt_desc_hist.shape[1]
    dev = m.pt_xyz.device
    pt = torch.clamp(kp_pt, 0, P - 1).long()
    safe_pt = torch.where((kp_pt >= 0) & ff.valid, pt, P)

    # 1) push into the ring reservoir; a point bound twice keeps the last
    # keypoint's descriptor in its slot and counts both
    slot = (m.pt_desc_n[pt] % M).long()
    hist = _set_drop_last(m.pt_desc_hist.reshape(P * M, 8),
                          torch.where(safe_pt < P, safe_pt * M + slot, P * M),
                          ff.desc).reshape(P, M, 8)
    desc_n = torch.cat([m.pt_desc_n, m.pt_desc_n[:1]]).index_add(
        0, safe_pt, torch.ones_like(safe_pt, dtype=torch.int32))[:P]

    # 2) min-median Hamming over each touched point's reservoir
    h = hist[pt]                                        # (N, M, 8)
    nvals = torch.clamp_max(desc_n[pt], M)              # (N,)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    # (h >> s) & 1 on int32 bit patterns gives the same bits as on uint32
    bits = ((h[..., None] >> shifts) & 1).reshape(h.shape[0], M, 256).to(torch.float32)
    ones = torch.sum(bits, dim=-1)                      # (N, M)
    dot = torch.einsum("nmb,nkb->nmk", bits, bits)      # (N, M, M)
    D = ones[:, :, None] + ones[:, None, :] - 2.0 * dot
    BIG = 1e9
    slot_ok = torch.arange(M, device=dev)[None, :] < nvals[:, None]
    Ds = torch.sort(torch.where(slot_ok[:, None, :], D, BIG), dim=-1).values
    med_idx = (torch.clamp_min(nvals - 1, 0) // 2).long()
    med = torch.gather(Ds, 2, med_idx[:, None, None].expand(-1, M, 1))[..., 0]
    best = torch.argmin(torch.where(slot_ok, med, BIG), dim=-1)
    best_desc = h[torch.arange(h.shape[0], device=dev), best]   # (N, 8)
    desc = _set_drop_last(m.pt_desc, safe_pt, best_desc)
    return m._replace(pt_desc=desc, pt_desc_hist=hist, pt_desc_n=desc_n)
