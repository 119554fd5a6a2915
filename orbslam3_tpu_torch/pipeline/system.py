"""The synchronous keyframe step of the monocular system.

Counterpart of the keyframe programs of `orbslam3_tpu/pipeline/system.py`
(`System._insert_kf`, `_cull`, `_local_ba`, `_kf_step`,
`_kf_pose_refresh`, `_remap_bindings` and the map stages of
`_post_ba_stages`) as module-level functions of the configuration, the
camera parameters and the state they act on.  The `System` class itself
(initialization, the tracking state machine, the asynchronous mapping
path) is not ported yet.

Everything stays on the device except where `System` itself reads a value
back: the redundancy flags of keyframe culling and the capacity check of
slot compaction, both in `post_ba_stages`.  The keyframe index `ki` of
`post_ba_stages` is a host int, as `System` mirrors it on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..features.extractor import FeatureFrame, OrbParams
from ..ops import lie
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _row, _set_drop, _set_drop_last
from . import fusion, mapping


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """The JAX package's `SlamConfig` (system.py:52-121) with the same
    fields and defaults; the port reads the mapping fields so far."""
    cam_model: str = "pinhole"
    cam_params: tuple = (458.654, 457.296, 367.215, 248.375)
    image_hw: tuple = (480, 752)
    orb: OrbParams = OrbParams()
    map_capacity: mapstate.MapCapacity = mapstate.MapCapacity()
    # tracking thresholds (reference src/Tracking.cc:932,985-1005)
    min_init_matches: int = 100
    min_track_inliers: int = 30
    # bounded local-map view for per-frame tracking (reference
    # UpdateLocalKeyFrames/UpdateLocalPoints, src/Tracking.cc:2964-3090);
    # 0 = track against the full capacity
    local_view_points: int = 8192
    local_view_kfs: int = 12
    max_frames_between_kf: int = 15
    kf_inlier_ratio: float = 0.75     # insert a KF when inliers decay to this
    new_pt_budget: int = 768
    tri_neighbors: int = 4     # triangulation partners (1 temporal + covis)
    local_ba_window: int = 8
    local_ba_iters: int = 6
    ba_pcg_iters: int = 12
    # window BA capacities: cameras, points, observations
    ba_caps: tuple = (16, 4096, 12288)
    # > 1: shard the local BA over this many devices (not ported yet)
    ba_mesh_shards: int = 0
    async_mapping: bool = False
    enable_loop_closing: bool = False
    post_loop_gba: bool = True
    gba_iters: int = 8
    enable_relocalization: bool = True
    reloc_patience: int = 10
    image_timeout: float = 3.0
    stereo_bf: float = 0.0     # fx * baseline; > 0 enables stereo residuals
    fuse_every_n_kf: int = 4   # SearchInNeighbors cadence (0 = off)
    kf_culling: bool = True    # KeyFrameCulling
    enable_gnss: bool = False
    gnss_sigma: float = 0.5
    gnss_min_kfs: int = 10
    gnss_ba_every: int = 4
    gnss_ba_cams: int = 64
    gnss_time_tol: float = 0.05


def insert_kf(cfg: SlamConfig, cam, m: mapstate.MapState, bank: fb.FeatureBank,
              ff: FeatureFrame, kp_pt, R, t, ts, frame_id, kp_ur):
    """Keyframe insertion + triangulation against the covisible neighbours
    (reference ProcessNewKeyFrame + CreateNewMapPoints,
    src/LocalMapping.cc:321-726).  Returns (map, bank, ki, kp_pt_new,
    n_new) with ki and n_new 0-d device tensors."""
    sf, nl = cfg.orb.scale_factor, cfg.orb.n_levels
    m, ki = mapstate.add_keyframe(m, R, t, ts, frame_id)
    bank = fb.set_frame(bank, ki, ff, kp_pt, ur=kp_ur)
    nbr_idx, nbr_ok = mapping.select_triangulation_neighbors(m, ki, cfg.tri_neighbors)
    nps = mapping.triangulate_vs_neighbors(
        m, bank, ki, ff, (kp_pt < 0) & ff.valid, nbr_idx, nbr_ok,
        cfg.cam_model, cam, cam, sf, nl)
    # budget across all neighbours, widest parallax first
    N = nps.valid.shape[1]
    B = cfg.new_pt_budget
    valid = nps.valid.reshape(-1)
    order = torch.argsort(torch.where(valid, nps.score.reshape(-1), 2.5),
                          stable=True)[:B]
    sel_valid = valid[order]
    sel_nn = order // N
    sel_i = order % N
    Ow = -(t @ R)
    X_sel = nps.xyz.reshape(-1, 3)[order]
    desc_sel = ff.desc[sel_i]
    oct_sel = ff.octave[sel_i]
    normal, dmin, dmax = mapping.point_descriptor_stats(X_sel, desc_sel, Ow,
                                                        oct_sel, sf, nl)
    m, pt_idx = mapstate.add_points(m, X_sel, desc_sel, normal, dmin, dmax,
                                    ki, frame_id, sel_valid)
    created = sel_valid & (pt_idx >= 0)
    # one observation append: the new KF's tracked points, the new points
    # at the new KF, and the new points at their winning neighbour
    prev_j = nps.kp_prev.reshape(-1)[order]
    prev_j_c = torch.clamp_min(prev_j, 0).long()
    sel_nb = nbr_idx[sel_nn]
    nbr_msk = created & (prev_j >= 0)
    m = mapstate.add_observations(
        m, torch.cat([ki.expand(N), ki.expand(B), sel_nb.to(torch.int32)]),
        torch.cat([kp_pt, pt_idx, pt_idx]),
        torch.cat([ff.xy, ff.xy[sel_i], bank.xy[sel_nb, prev_j_c]]),
        torch.cat([ff.octave, oct_sel, bank.octave[sel_nb, prev_j_c]]),
        torch.cat([(kp_pt >= 0) & ff.valid, created, nbr_msk]),
        ur=torch.cat([kp_ur, kp_ur[sel_i],
                      torch.full((B,), -1.0, dtype=torch.float32, device=kp_ur.device)]))
    # the neighbours' bindings of the matched keypoints
    K_cap, Nb = bank.kp_pt.shape
    flat = torch.where(nbr_msk, sel_nb * Nb + prev_j_c, K_cap * Nb)
    bank = bank._replace(kp_pt=_set_drop_last(
        bank.kp_pt.reshape(-1), flat, pt_idx).reshape(K_cap, Nb))
    kp_pt_new = _set_drop(kp_pt, torch.where(created, sel_i, N), pt_idx)
    bank = fb.set_binding(bank, ki, kp_pt_new)
    return m, bank, ki, kp_pt_new, torch.sum(created.to(torch.int32))


def local_ba(cfg: SlamConfig, cam, m: mapstate.MapState, center_kf,
             bank: fb.FeatureBank | None = None) -> mapstate.MapState:
    """The window BA of the keyframe step (grid solver, bank-sourced when a
    bank is given)."""
    if cfg.ba_mesh_shards > 1:
        raise NotImplementedError("the sharded local BA is queue 1 item 10")
    cams, pts, obs = cfg.ba_caps
    return mapping.run_local_ba(
        m, center_kf, cfg.cam_model, cam, window=cfg.local_ba_window,
        iterations=cfg.local_ba_iters, scale_factor=cfg.orb.scale_factor,
        n_levels=cfg.orb.n_levels, stereo_bf=cfg.stereo_bf, bank=bank,
        cap_cams=cams, cap_pts=pts, cap_obs=obs)


def cull(m: mapstate.MapState, frame_id) -> mapstate.MapState:
    return mapstate.cull_points(m, frame_id)


def kf_pose_refresh(m: mapstate.MapState, ki, R_cur, t_cur, R_prev, t_prev):
    """Tracker pose refresh from the optimized keyframe, with the BA
    correction carried to the previous-frame pose so that the
    constant-velocity model does not see it as motion.  Returns (R_prev,
    t_prev, R_cur, t_cur)."""
    R_k, t_k = _row(m.kf_R, ki), _row(m.kf_t, ki)
    dR, dt = lie.se3_compose(R_k, t_k, *lie.se3_inverse(R_cur, t_cur))
    Rp, tp = lie.se3_compose(dR, dt, R_prev, t_prev)
    return Rp, tp, R_k, t_k


def local_view(cfg: SlamConfig, m: mapstate.MapState, center):
    """The tracking view around `center` (None when the view is off)."""
    if cfg.local_view_points <= 0:
        return None
    return mapstate.gather_local_view(m, center, cfg.local_view_points,
                                      window=cfg.local_view_kfs)


def kf_step(cfg: SlamConfig, cam, m: mapstate.MapState, bank: fb.FeatureBank,
            ff: FeatureFrame, kp_pt, R, t, ts, frame_id, kp_ur, center):
    """The synchronous keyframe frame: insert + triangulate, point culling,
    window BA and the tracking-view rebuild around `center`.  Returns
    (map, bank, ki, kp_pt_new, n_new, view)."""
    m, bank, ki, kp_pt_new, n_new = insert_kf(cfg, cam, m, bank, ff, kp_pt,
                                              R, t, ts, frame_id, kp_ur)
    m = cull(m, frame_id)
    m = local_ba(cfg, cam, m, center, bank)
    return m, bank, ki, kp_pt_new, n_new, local_view(cfg, m, center)


def remap_bindings(kp, remap):
    """Apply `state.compact`'s point remap to keypoint bindings."""
    P = remap.shape[0]
    return torch.where(kp >= 0, remap[torch.clamp(kp, 0, P - 1).long()], -1)


def post_ba_stages(cfg: SlamConfig, cam, m: mapstate.MapState,
                   bank: fb.FeatureBank, ki: int, ff: FeatureFrame, kp_pt, view):
    """The map stages after the window BA (system.py:991-1036): fusion into
    keyframe `ki` every `fuse_every_n_kf` keyframes, keyframe culling at
    ki > 6 and ki % 4 == 0, and slot compaction at ki % 8 == 0 above 85%
    of the point or observation capacity.  Returns (map, bank, kp_pt of
    `ki`, view); the view is rebuilt around `ki` if a stage changed the
    map.  Loop closing with the keyframe database (queue 1 item 5) and
    the GNSS stage (item 9) are not ported yet and are left out."""
    dirty = False
    # SearchInNeighbors (reference src/LocalMapping.cc:764), then
    # ComputeDistinctiveDescriptors on the touched points (:838-843)
    if cfg.fuse_every_n_kf and ki % cfg.fuse_every_n_kf == 0:
        m, kp_pt, _ = fusion.fuse_into_keyframe(
            m, ki, ff, kp_pt, cfg.cam_model, cam, cfg.image_hw,
            cfg.orb.scale_factor, cfg.orb.n_levels)
        m = fusion.refresh_point_descriptors(m, ff, kp_pt)
        bank = fb.set_binding(bank, ki, kp_pt)
        dirty = True
    # KeyFrameCulling (reference src/LocalMapping.cc:902): the flags are
    # read back, as System does, and the first redundant KF goes
    if cfg.kf_culling and ki > 6 and ki % 4 == 0:
        reds = torch.nonzero(fusion.redundancy_window(m, ki)).flatten().tolist()
        if reds:
            m = fusion.cull_keyframe(m, reds[0])
            dirty = True
    # slot reclamation near capacity
    if ki % 8 == 0:
        cap = cfg.map_capacity
        if int(m.n_pt) > 0.85 * cap.n_pt or int(m.n_obs) > 0.85 * cap.n_obs:
            m, remap = mapstate.compact(m)
            kp_pt = remap_bindings(kp_pt, remap)
            bank = bank._replace(kp_pt=remap_bindings(bank.kp_pt, remap))
            dirty = True
    if dirty or view is None:
        view = local_view(cfg, m, ki)
    return m, bank, kp_pt, view
