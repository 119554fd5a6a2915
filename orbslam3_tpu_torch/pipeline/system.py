"""System facade: the monocular SLAM engine loop.

Counterpart of `orbslam3_tpu/pipeline/system.py` (parity target: reference
System + Tracking state machine, src/System.cc, src/Tracking.cc):
  * state machine NO_IMAGES_YET -> NOT_INITIALIZED -> OK / RECENTLY_LOST
    (include/Tracking.h:119-127),
  * MonocularInitialization: two frames with enough keypoints, window
    matching, two-view reconstruction, the initial map with median-depth
    normalization and a two-keyframe BA (src/Tracking.cc:566-768),
  * per frame: motion-model prediction -> TrackLocalMap -> keyframe
    decision -> the keyframe frame (insertion, triangulation, point
    culling, window BA, fusion, keyframe culling, compaction, loop closing),
  * with `async_mapping`, the reference's Tracking || LocalMapping overlap
    (src/System.cc:113): the keyframe frame inserts and triangulates, then
    posts point culling + window BA as a pending chain against the
    post-insert snapshot, and the optimized map is swapped in by
    `_merge_pending` (polled every tracked frame, forced at the next
    keyframe, a loss, an archive, localization mode and shutdown), where
    the stages after the BA run,
  * loss: every lost frame tries to relocalize against the keyframe
    database (upstream Tracking::Relocalization); RECENTLY_LOST for
    `reloc_patience` frames, then the map is archived in the Atlas and a
    fresh one started (src/Tracking.cc:543-544),
  * timestamp failsafes (src/Tracking.cc:383-395).

The keyframe programs (`System._insert_kf`, `_cull`, `_local_ba`,
`_kf_step`, `_kf_pose_refresh`, `_remap_bindings`, `_cull_ba`, `_gba`,
`_merge_opt` and the map stages of `_post_ba_stages`) are module-level
functions of the configuration, the camera parameters and the state they
act on; the `System` class drives them.  Each keyframe's features and
bindings live in the device feature bank only (the JAX class also mirrors
them in host dictionaries), so a pending keyframe chain carries its
keyframe's `FeatureFrame` for the stages run at its swap-in.

The pending chain (the async keyframe tail, or the full-map GBA that a loop
closure posts) runs on a dedicated CUDA stream, which first waits for the
current stream; an event recorded after the chain is what the per-frame
poll queries (JAX's `is_ready`), and a forced merge makes the current
stream wait on it, not the host.  The chain's inputs stay referenced by the
pending entry until the merge, and its outputs are marked with
`record_stream` there, so that the caching allocator reuses no block that
the other stream still reads.  Nothing on the tracked-frame path writes in
place into a map tensor (every op returns new tensors), so the snapshot the
chain reads stays as it was.  The host still issues the chain's launches
from its one thread, between the tracked frame's: the overlap is on the
card.  On the CPU the chain runs inline and a poll always finds it done.

With `enable_relocalization` (true by default, as in the JAX package) the
`System` builds a `loop_closing.LoopCloser`: the 65536-word vocabulary and
the keyframe database, fed with both initial keyframes and with every
inserted keyframe, erased of a culled keyframe, archived with the map's Atlas
session, and queried by `relocalization.attempt_relocalization` on every
lost frame.  With `enable_loop_closing` and an archived session, each
keyframe first tries to weld the current map into that session
(`map_merging.try_merge`, the multi-session Atlas) and tries a loop closure
only if it did not merge.

With `enable_gnss` (the fork's GNSS georeferencing) `grab_gnss` queues
fixes; each keyframe, after loop closing and when no chain is pending, takes
the nearest fix in time, feeds the Umeyama georeference
(`geometry.georef.GeometricReferencer`) and, once it is initialized, every
`gnss_ba_every`-th keyframe posts the GNSS-constrained BA (position priors
on every keyframe with a fix) as a "gba" pending chain;
`trajectory_geo` gives the trajectory in the geo frame.
`slam_map/checkpoint.py` saves and restores a `System`.

The camera is a pinhole or a Kannala-Brandt-8 fisheye (`cam_model="kb8"`:
two-view initialization runs on bearings, triangulation gates in ray
space).  The stereo, RGB-D and stereo-inertial Systems
(`stereo_system.py`, `rgbd_system.py`, `stereo_inertial_system.py`) build on
this class through its hooks `_frame_kp_ur` (the keyframe's right-u rows) and
`_insert_keyframe`.  Not ported yet, and refused by `System` when the
configuration asks for it: the sharded BA.

Everything stays on the device except where the reference itself reads a
value back: per frame the inlier count (read together with the pose that
the trajectory records); per initialization attempt the keypoint count, the
match count, the outcome and the median depth; in the keyframe frame the
redundancy flags of keyframe culling and the capacity check of slot
compaction, both in `post_ba_stages`; per relocalization attempt the
database's scores and the batch's decision; per loop-closing attempt what
`LoopCloser.try_close` reads, per merge attempt what `map_merging.try_merge`
reads; per keyframe with a GNSS fix the keyframe's centre.  Feeding the
database reads nothing.  Keyframe indices are host ints, as the JAX class
mirrors them on the host.

The stages are marked with `utils/profiling` spans (`frame`, `upload`,
`extract`, `initialize`, `track`, `host_read`, `keyframe` with `insert_kf`,
`cull`, `window_ba` and `post_ba_stages`), and each keyframe is counted by
the rule that inserted it; the tracer is off unless enabled.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..features import extractor
from ..features.extractor import FeatureFrame, OrbParams
from ..geometry import georef as georef_mod
from ..geometry import twoview
from ..ops import cameras, lie, matching
from ..slam_map import atlas as atlas_mod
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _row, _set_drop, _set_drop_last, _upload
from . import fusion, loop_closing, map_merging, mapping, relocalization, tracking
from ..place import keyframe_db as kdb
from ..utils import profiling

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """The JAX package's `SlamConfig` (system.py:52-121) with the same
    fields and defaults."""
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
    # > 1: shard the local BA over this many shards (`local_ba`)
    ba_mesh_shards: int = 0
    async_mapping: bool = False
    enable_loop_closing: bool = False
    post_loop_gba: bool = True
    gba_iters: int = 8
    enable_relocalization: bool = True   # keyframe database + relocalization on loss
    reloc_patience: int = 10   # frames in RECENTLY_LOST before map reset
    # timestamp failsafes (reference src/Tracking.cc:383-395): a frame older
    # than its predecessor archives the map and starts a fresh one; a gap
    # longer than image_timeout declares the track lost
    image_timeout: float = 3.0
    stereo_bf: float = 0.0     # fx * baseline; > 0 enables stereo residuals
    fuse_every_n_kf: int = 4   # SearchInNeighbors cadence (0 = off)
    kf_culling: bool = True    # KeyFrameCulling
    # GNSS georeferencing (reference src/GeometricReferencer.cpp and
    # LocalGNSSBundleAdjustment, src/Optimizer.cc:1362-1604): fixes through
    # grab_gnss(); once the georeference is initialized, keyframe positions
    # get GNSS position priors in the GNSS BA
    enable_gnss: bool = False
    gnss_sigma: float = 0.5        # fix standard deviation in SLAM-frame units
    gnss_min_kfs: int = 10         # fixes before the Umeyama fit
    gnss_ba_every: int = 4         # GNSS BA cadence (keyframes)
    gnss_ba_cams: int = 64         # keyframe capacity of the GNSS BA window
    gnss_time_tol: float = 0.05    # fix <-> frame association tolerance [s]


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
    bank is given).  With `ba_mesh_shards > 1` it runs sharded
    (`parallel.dist_ba` through `run_local_ba(mesh=)`) over `ba_mesh_shards`
    shards: all on the map's device, or spread over the processes of the
    default `torch.distributed` group when one is initialized (its size
    must divide the shard count).  The point and observation caps are then
    rounded up to multiples of the shard count, as in JAX
    (system.py:374-381).  JAX solves on one device when it has fewer
    devices than shards (system.py:364-369); the port always shards, on
    the one card if need be."""
    cams, pts, obs = cfg.ba_caps
    mesh = None
    if cfg.ba_mesh_shards > 1:
        from ..parallel import multihost
        s = cfg.ba_mesh_shards
        world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
        if s % world:
            raise ValueError(f"ba_mesh_shards {s} does not divide over {world} processes")
        mesh = multihost.global_mesh(local=s // world)
        pts = -(-pts // s) * s
        obs = -(-obs // s) * s
    return mapping.run_local_ba(
        m, center_kf, cfg.cam_model, cam, window=cfg.local_ba_window,
        iterations=cfg.local_ba_iters, scale_factor=cfg.orb.scale_factor,
        n_levels=cfg.orb.n_levels, stereo_bf=cfg.stereo_bf, mesh=mesh,
        pcg_iters=cfg.ba_pcg_iters, bank=bank, cap_cams=cams, cap_pts=pts, cap_obs=obs)


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
            ff: FeatureFrame, kp_pt, R, t, ts, frame_id, kp_ur, center, ba=None):
    """The synchronous keyframe frame: insert + triangulate, point culling,
    window BA and the tracking-view rebuild around `center`.  `ba(m,
    center, bank)` takes the place of the visual window BA (the inertial
    System's visual-inertial one); it is given the bank that holds the new
    keyframe's rows, which its gather reads.  Returns (map, bank, ki,
    kp_pt_new, n_new, view)."""
    with profiling.span("insert_kf"):
        m, bank, ki, kp_pt_new, n_new = insert_kf(cfg, cam, m, bank, ff, kp_pt,
                                                  R, t, ts, frame_id, kp_ur)
    with profiling.span("cull"):
        m = cull(m, frame_id)
    with profiling.span("window_ba"):
        m = local_ba(cfg, cam, m, center, bank) if ba is None else ba(m, center, bank)
    return m, bank, ki, kp_pt_new, n_new, local_view(cfg, m, center)


def remap_bindings(kp, remap):
    """Apply `state.compact`'s point remap to keypoint bindings."""
    P = remap.shape[0]
    return torch.where(kp >= 0, remap[torch.clamp(kp, 0, P - 1).long()], -1)


def post_ba_stages(cfg: SlamConfig, cam, m: mapstate.MapState,
                   bank: fb.FeatureBank, ki: int, ff: FeatureFrame, kp_pt, view,
                   loop_closer: Optional[loop_closing.LoopCloser] = None):
    """The map stages after the window BA (system.py:991-1036): fusion into
    keyframe `ki` every `fuse_every_n_kf` keyframes, keyframe culling at
    ki > 6 and ki % 4 == 0, and slot compaction at ki % 8 == 0 above 85%
    of the point or observation capacity.  Returns (map, bank, kp_pt of
    `ki`, view, culled): the view is rebuilt around `ki` if a stage changed
    the map, and `culled` is the index of the keyframe that culling removed
    (None if none), for what the caller keeps per keyframe beside the map.
    With a `loop_closer` its keyframe database follows the map: a culled
    keyframe is erased from it (reference KeyFrame::SetBadFlag ->
    KeyFrameDatabase::erase, src/KeyFrameDatabase.cc:66: a culled keyframe
    must never come back as a candidate with its frozen pose), and without
    loop closing keyframe `ki` is registered at the end (the JAX stage's
    relocalization-only mode; with it, `LoopCloser.try_close` registers the
    keyframe, after this function, in `System._post_ba_stages`, which also
    runs map merging and the GNSS stage)."""
    dirty = False
    culled = None
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
            culled = reds[0]
            m = fusion.cull_keyframe(m, culled)
            if loop_closer is not None:
                loop_closer.db = kdb.erase(loop_closer.db, culled)
            dirty = True
    # slot reclamation near capacity
    if ki % 8 == 0:
        cap = cfg.map_capacity
        if int(m.n_pt) > 0.85 * cap.n_pt or int(m.n_obs) > 0.85 * cap.n_obs:
            m, remap = mapstate.compact(m)
            kp_pt = remap_bindings(kp_pt, remap)
            bank = bank._replace(kp_pt=remap_bindings(bank.kp_pt, remap))
            dirty = True
    if loop_closer is not None and not cfg.enable_loop_closing:
        loop_closer.add_keyframe(m, ki, ff)
    if dirty or view is None:
        view = local_view(cfg, m, ki)
    return m, bank, kp_pt, view, culled


def gnss_ba(cfg: SlamConfig, cam, m: mapstate.MapState, center_kf, prior_pos, prior_w,
            bank: fb.FeatureBank) -> mapstate.MapState:
    """The GNSS-constrained BA (the fork's LocalGNSSBundleAdjustment,
    src/Optimizer.cc:1362-1604: every keyframe, reprojections and GNSS
    position priors): the capacity-wide temporal window from the bank with
    `gnss_ba_cams` cameras, 6144 points and 24576 observations, through the
    COO bundle adjuster's PCG Schur solve."""
    return mapping.run_local_ba(
        m, center_kf, cfg.cam_model, cam, window=cfg.map_capacity.n_kf,
        iterations=cfg.local_ba_iters, scale_factor=cfg.orb.scale_factor,
        n_levels=cfg.orb.n_levels, stereo_bf=cfg.stereo_bf, prior_pos=prior_pos,
        prior_w=prior_w, bank=bank, cap_cams=cfg.gnss_ba_cams, cap_pts=6144, cap_obs=24576,
        window_mode="temporal")


def cull_ba(cfg: SlamConfig, cam, m: mapstate.MapState, frame_id, center,
            bank: fb.FeatureBank) -> mapstate.MapState:
    """The async keyframe chain: point culling and the window BA."""
    return local_ba(cfg, cam, cull(m, frame_id), center, bank)


def gba(cfg: SlamConfig, cam, m: mapstate.MapState, center_kf,
        bank: fb.FeatureBank) -> mapstate.MapState:
    """The full-map global BA after a loop closure (reference
    GlobalBundleAdjustemnt, src/Optimizer.cc:60-76: every keyframe and point,
    the first keyframe fixed): the capacity-wide temporal window from the
    bank through the COO bundle adjuster's PCG Schur solve (a grid would be
    a (P, K) slab at 24576 x 256)."""
    cap = cfg.map_capacity
    return mapping.run_local_ba(
        m, center_kf, cfg.cam_model, cam, window=cap.n_kf, iterations=cfg.gba_iters,
        scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
        stereo_bf=cfg.stereo_bf, pcg_iters=cfg.ba_pcg_iters, schur_solver="pcg",
        window_mode="temporal", cap_cams=cap.n_kf, cap_pts=cap.n_pt, cap_obs=cap.n_obs,
        bank=bank)


def anchor_correction(m_live: mapstate.MapState, m_opt: mapstate.MapState):
    """A: live world -> optimized world, x -> R_A x + t_A, from the last
    keyframe of the optimized snapshot: A = (T_a^opt)^-1 T_a^live."""
    a = torch.clamp_min(m_opt.n_kf - 1, 0)
    R_ao, t_ao = _row(m_opt.kf_R, a), _row(m_opt.kf_t, a)
    R_A = R_ao.T @ _row(m_live.kf_R, a)
    return R_A, R_ao.T @ (_row(m_live.kf_t, a) - t_ao)


def merge_opt(m_live: mapstate.MapState, m_opt: mapstate.MapState) -> mapstate.MapState:
    """Swap an optimized snapshot's geometry into the live map: keyframe
    poses, point positions and cull verdicts from the snapshot, the tracking
    counters from the live map.  Keyframes and points appended after the
    snapshot are not in it; they ride the anchor correction A (the analogue
    of the reference carrying the GBA correction to keyframes created during
    the GBA through the spanning tree, src/LoopClosing.cc
    RunGlobalBundleAdjustment): T_j = T_j^live A^-1, X = A X^live, world
    velocities rotated by R_A."""
    P, K = m_live.pt_xyz.shape[0], m_live.kf_R.shape[0]
    dev = m_live.pt_xyz.device
    new_pt = torch.arange(P, device=dev) >= m_opt.n_pt
    new_kf = torch.arange(K, device=dev) >= m_opt.n_kf
    R_A, t_A = anchor_correction(m_live, m_opt)
    Rj = m_live.kf_R @ R_A.T
    tj = m_live.kf_t - torch.einsum("kij,j->ki", Rj, t_A)
    return m_live._replace(
        kf_R=torch.where(new_kf[:, None, None], Rj, m_opt.kf_R),
        kf_t=torch.where(new_kf[:, None], tj, m_opt.kf_t),
        kf_vel=torch.where(new_kf[:, None], m_live.kf_vel @ R_A.T, m_opt.kf_vel),
        kf_bias=torch.where(new_kf[:, None], m_live.kf_bias, m_opt.kf_bias),
        pt_xyz=torch.where(new_pt[:, None], m_live.pt_xyz @ R_A.T + t_A, m_opt.pt_xyz),
        pt_valid=torch.where(new_pt, m_live.pt_valid, m_live.pt_valid & m_opt.pt_valid))


class Pending(NamedTuple):
    """A posted device chain: its optimized map, the keyframe it was posted
    for, its kind ("kf": the async keyframe tail, whose keyframe's features
    and timestamp the stages after the BA need at swap-in; "gba": the
    full-map GBA), the event recorded after it on the side stream (None on
    the CPU) and the inputs it reads, kept alive until the merge."""
    m_opt: mapstate.MapState
    ki: int
    kind: str
    ff: Optional[FeatureFrame]
    ts: float
    done: Optional[torch.cuda.Event]
    inputs: tuple


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x[mask] as `np.nanmedian` / `jnp.nanmedian` define it: an
    even count averages the two middle values (`torch.nanmedian` returns
    the lower one).  0-d tensor, NaN for an empty mask; stays on the device."""
    n = torch.sum(mask.to(torch.int64))
    srt = torch.sort(torch.where(mask, x, float("inf"))).values
    lo = _row(srt, torch.clamp_min((n - 1) // 2, 0))
    hi = _row(srt, n // 2)
    return torch.where(n > 0, (lo + hi) * 0.5, float("nan"))


def renorm_init(m: mapstate.MapState, kf2) -> mapstate.MapState:
    """Rescale the whole initial map so that the median point depth in the
    second keyframe is 1 (reference Tracking.cc:698-729, applied after the
    initial BA).  pt_min/max_dist stay: they were computed at the pre-BA
    median-depth-1 scale, which this restores."""
    Xc = lie.se3_apply(_row(m.kf_R, kf2), _row(m.kf_t, kf2), m.pt_xyz)
    med = masked_median(Xc[:, 2], m.pt_valid & (Xc[:, 2] > 0))
    s = torch.where(torch.isfinite(med) & (med > 1e-6), 1.0 / med, 1.0)
    return m._replace(pt_xyz=m.pt_xyz * s, kf_t=m.kf_t * s)


class System:
    """Host-side orchestrator.  One instance per SLAM run.  All state
    tensors live on `device`: the first CUDA device unless the caller names
    another (`"cpu"` runs the plain versions of the kernels)."""

    def __init__(self, config: SlamConfig, device=None, seed: int = 42):
        self.cfg = config
        self.device = torch.device("cuda", 0) if device is None else torch.device(device)
        dev = self.device
        self.cam_params = torch.tensor(config.cam_params, dtype=torch.float32, device=dev)
        self.state = NO_IMAGES_YET
        self.map = mapstate.empty_map(config.map_capacity, dev)
        self.frame_id = -1
        # draws the RANSAC samples of two-view initialization, relocalization,
        # loop closing and map merging: on the CPU whatever the device, so
        # that a card makes the CPU's draws (`ops/sampling.py`)
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)
        # tracker state
        self.R_cur = torch.eye(3, device=dev)
        self.t_cur = torch.zeros(3, device=dev)
        self.R_prev = torch.eye(3, device=dev)
        self.t_prev = torch.zeros(3, device=dev)
        self._pose_host = None        # (R_cur, t_cur) in numpy when read already
        self.has_velocity = False
        self.ref_ff: Optional[FeatureFrame] = None   # init reference frame
        self.ref_ts = 0.0
        self.ref_frame_id = -1
        self.last_kf_id = -1          # frame id of last keyframe
        self.last_kf_idx = -1         # map index of last keyframe
        # per-keyframe features and bindings; sized lazily from the first
        # frame's keypoint capacity (tests feed arbitrary-capacity frames)
        self.bank: Optional[fb.FeatureBank] = None
        # bounded local-map view (None = track against full capacity);
        # refreshed once per keyframe
        self.view: Optional[mapstate.PointView] = None
        # localization-only mode: track against the frozen map, never
        # insert keyframes (reference mbOnlyTracking)
        self.localization_only = False
        self.inliers_at_last_kf = 0
        self.last_track_inliers = 0
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.n_resets = 0
        self._prev_frame_ts: Optional[float] = None
        self.n_map_switches = 0   # CreateMapInAtlas events (not resets)
        # host mirror of map.n_kf / last KF timestamp: keyframe indices are
        # host-predictable (append-only), so the hot path never reads them
        self.n_kf_host = 0
        self.last_kf_ts = 0.0
        # the keyframe database backs both loop closing and relocalization
        # (the reference keeps it alive with loop closing off, src/System.cc:93)
        self.loop_closer: Optional[loop_closing.LoopCloser] = None
        if config.enable_loop_closing or config.enable_relocalization:
            self.loop_closer = loop_closing.LoopCloser(
                loop_closing.LoopConfig(), config.map_capacity.n_kf, dev)
        self.atlas = atlas_mod.Atlas(config.map_capacity)
        self.lost_frames = 0
        # what the last successful initialization did: frame ids, the model
        # that won, the number of points
        self.init_info: Optional[dict] = None
        # the pending device chain (None or a Pending) and its side stream;
        # subclasses that couple tracking to the keyframe chain (inertial)
        # clear _async_ok to keep the keyframe step synchronous
        self._pending: Optional[Pending] = None
        self._async_ok = True
        self._side_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # chains posted and merged, by kind and by how they were merged
        self.chain_counts: collections.Counter = collections.Counter()
        # what the last map merge did (`map_merging.try_merge`), None if none
        self.last_merge: Optional[dict] = None
        # GNSS georeferencing: the fixes not yet associated, the fix of each
        # keyframe that has one (geo frame, re-based to the first fix), the
        # first fix, and the GNSS BAs posted
        self.georef: Optional[georef_mod.GeometricReferencer] = None
        self.gnss_queue: list[tuple[float, np.ndarray]] = []
        self.kf_gnss: dict[int, np.ndarray] = {}
        self.gnss_origin: Optional[np.ndarray] = None
        self.n_gnss_ba = 0
        if config.enable_gnss:
            self.georef = georef_mod.GeometricReferencer(min_kfs=config.gnss_min_kfs)
        # the live viewer (viz_server.ViewerServer.attach) and the bindings of
        # the last tracked frame's keypoints, which its overlay colours
        self.viewer = None
        self.last_kp_pt: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- frontend
    def _extract(self, img) -> FeatureFrame:
        img = self._image_on_device(img)
        with profiling.span("extract"):
            return extractor.extract(img, self.cfg.orb)

    def _image_on_device(self, img) -> torch.Tensor:
        """A frame on the System's device: a host array through pinned
        memory without waiting for the device's queue (`state._upload`), a
        tensor as it is (moved if it lies elsewhere)."""
        with profiling.span("upload"):
            if isinstance(img, torch.Tensor):
                return img.to(self.device)
            return mapstate._upload(img, self.device)

    def _ensure_bank(self, ff: FeatureFrame):
        if self.bank is None or self.bank.xy.shape[1] != ff.capacity:
            self.bank = fb.empty_bank(self.cfg.map_capacity.n_kf, ff.capacity, self.device)

    def _bank_store(self, kf_idx: int, ff: FeatureFrame, kp_pt, ur=None):
        self._ensure_bank(ff)
        self.bank = fb.set_frame(self.bank, kf_idx, ff, kp_pt, ur=ur)

    def _refresh_view(self) -> None:
        """Rebuild the bounded local-map tracking view around the last
        keyframe."""
        self.view = local_view(self.cfg, self.map, self.last_kf_idx)

    def _frame_kp_ur(self, ff: FeatureFrame) -> torch.Tensor:
        """Per-keypoint stereo right-u for the current frame (-1 = mono)."""
        return torch.full((ff.xy.shape[0],), -1.0, dtype=torch.float32, device=self.device)

    def _set_pose(self, R, t, host=None) -> None:
        self.R_cur, self.t_cur = R, t
        self._pose_host = host

    def _pose_numpy(self):
        """(R_cur, t_cur) in numpy; one read unless this frame read them."""
        if self._pose_host is None:
            Rt = torch.cat([self.R_cur.reshape(-1), self.t_cur]).cpu().numpy()
            self._pose_host = (Rt[:9].reshape(3, 3), Rt[9:])
        return self._pose_host

    # ------------------------------------------------------------------ api
    def grab_gnss(self, ts: float, geo_xyz) -> None:
        """Queue one GNSS fix (a geo-frame position, e.g. EPSG3857 x, y and
        altitude; reference ImageGrabber's GNSS pump and conversions.hpp).
        Fixes are re-based to the first one in float64, then kept in float32."""
        if self.georef is None:
            return
        p = np.asarray(geo_xyz, np.float64)
        if self.gnss_origin is None:
            self.gnss_origin = p.copy()
        self.gnss_queue.append((ts, (p - self.gnss_origin).astype(np.float32)))

    def trajectory_geo(self) -> np.ndarray:
        """(N, 3) trajectory in the geo frame (the first fix added back)
        through the georeference (GeometricReferencer::apply); the SLAM
        trajectory until it is initialized."""
        est = np.stack([p[2] for p in self.trajectory]) if self.trajectory else np.zeros((0, 3))
        if self.georef is None or not self.georef.initialized:
            return est
        out = self.georef.apply(torch.from_numpy(est.astype(np.float32))).numpy()
        if self.gnss_origin is not None:
            out = out + self.gnss_origin[None, :]
        return out

    def track_monocular(self, img, ts: float, features: Optional[FeatureFrame] = None):
        """Process one frame.  Returns (state, (Rwc, twc) in numpy or None).

        `img`: (H, W) grayscale uint8 (numpy or tensor).  `features` may be
        supplied directly (tests, external front ends), on the system's
        device; otherwise they are extracted from `img`.
        """
        with self._next_frame():
            self._frame_start(ts)
            return self._track_monocular(img, ts, features)

    def _next_frame(self):
        """Count a new frame and open its `frame` span, the root of the
        frame's spans: every entry point's first step."""
        self.frame_id += 1
        return profiling.span("frame", self.frame_id)

    def _frame_start(self, ts: float) -> None:
        """Host work that opens every frame, before its timestamp checks
        (the inertial System packs the frame interval's IMU rows here)."""

    def _track_monocular(self, img, ts: float, features: Optional[FeatureFrame]):
        # timestamp-anomaly failsafes (reference src/Tracking.cc:383-395)
        if self.state != NO_IMAGES_YET and self._prev_frame_ts is not None:
            if ts < self._prev_frame_ts - 1e-9:
                # frame older than its predecessor: archive the current map
                # and start fresh (reference CreateMapInAtlas); the
                # anomalous frame itself is dropped
                self._create_map_in_atlas()
                self._prev_frame_ts = None
                return self.state, None
            if ts > self._prev_frame_ts + self.cfg.image_timeout and \
                    self.state in (OK, RECENTLY_LOST):
                # a blind gap longer than image_timeout: lost.  A young map
                # is reset, a mature one archived into the Atlas
                if self.n_kf_host <= 10:
                    self._reset()
                else:
                    self._create_map_in_atlas()
                self._prev_frame_ts = ts
                return self.state, None
        self._prev_frame_ts = ts
        # cleared every frame: the viewer's overlay must never colour this
        # frame's keypoints with an earlier frame's bindings
        self.last_kp_pt = None
        ff = features if features is not None else self._extract(img)

        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            with profiling.span("initialize"):
                self._initialize(ff, ts)
        elif self.state in (OK, RECENTLY_LOST):
            with profiling.span("track"):
                self._track_frame(ff, ts)

        out = None
        if self.state == OK:
            # record camera-to-world pose
            R_cw, t_cw = self._pose_numpy()
            Rwc = R_cw.T
            twc = -Rwc @ t_cw
            self.trajectory.append((ts, Rwc, twc))
            out = (Rwc, twc)
        if self.viewer is not None:
            # the live viewer (reference Viewer.cc camera-follow + step
            # mode): a snapshot and the annotated frame, then the pause gate
            self.viewer.publish(self)
            self.viewer.publish_frame(img, ff, self.last_kp_pt)
            self.viewer.wait_if_paused()
        return self.state, out

    # ----------------------------------------------------------------- init
    def _initialize(self, ff: FeatureFrame, ts: float):
        n_kp = int(torch.sum(ff.valid))
        if self.state == NO_IMAGES_YET or self.ref_ff is None:
            if n_kp >= self.cfg.min_init_matches:
                self.ref_ff = ff
                self.ref_ts = ts
                self.ref_frame_id = self.frame_id
                self.state = NOT_INITIALIZED
            return
        if n_kp < self.cfg.min_init_matches:
            self.ref_ff = None
            self.state = NO_IMAGES_YET
            return
        mm = matching.search_for_initialization(self.ref_ff, ff, radius=100.0,
                                                nn_ratio=0.9)
        n_matches = int(torch.sum(mm.valid))
        if n_matches < self.cfg.min_init_matches:
            # slide the reference (the reference replaces it when matching fails)
            self.ref_ff = ff
            self.ref_ts = ts
            self.ref_frame_id = self.frame_id
            return
        # matched pairs: ref kp i <-> cur kp mm.idx[i]
        j = torch.clamp_min(mm.idx, 0).long()
        res = self._reconstruct(self.ref_ff.xy, ff.xy[j], mm.valid)
        success, used_h = torch.stack([res.success, res.used_homography]).tolist()
        if not success:
            return
        self._create_initial_map(ff, mm, res, ts, used_homography=used_h)

    def _reconstruct(self, xy1, xy2, valid, idx=None) -> twoview.TwoViewResult:
        """Two-view reconstruction of matched keypoints (`idx`: the RANSAC
        samples, None to draw them).  A non-pinhole camera (KB8) runs the
        F / H machinery on bearings over a unit virtual pinhole with the
        pixel sigma scaled by the focal length (system.py:212-228; the
        reference's KannalaBrandt8 path reconstructs from rays)."""
        if self.cfg.cam_model == "pinhole":
            return twoview.reconstruct(xy1, xy2, valid, self.cam_params, idx=idx,
                                       generator=self.generator)
        b1 = cameras.unproject(self.cfg.cam_model, self.cam_params, xy1)
        b2 = cameras.unproject(self.cfg.cam_model, self.cam_params, xy2)
        # 1 / fx in float32, as the JAX program divides its float32 parameter
        sigma = float(np.float32(1.0) / np.float32(self.cfg.cam_params[0]))
        return twoview.reconstruct(b1[:, :2] / b1[:, 2:3], b2[:, :2] / b2[:, 2:3], valid,
                                   cameras.unit_pinhole(self.device), idx=idx,
                                   generator=self.generator, sigma=sigma)

    def _create_initial_map(self, ff: FeatureFrame, mm, res, ts: float,
                            used_homography: bool | None = None):
        cfg = self.cfg
        dev = self.device
        tri = res.triangulated
        # median-depth normalization (reference src/Tracking.cc:698-729)
        med = float(masked_median(res.points3d[:, 2], tri))
        if not np.isfinite(med) or med <= 0:
            return
        inv_med = 1.0 / med
        X = res.points3d * inv_med
        t21 = res.t21 * inv_med

        m = mapstate.empty_map(cfg.map_capacity, dev)
        m, k1 = mapstate.add_keyframe(m, torch.eye(3, device=dev),
                                      torch.zeros(3, device=dev),
                                      self.ref_ts, self.ref_frame_id)
        m, k2 = mapstate.add_keyframe(m, res.R21, t21, ts, self.frame_id)

        j = torch.clamp_min(mm.idx, 0).long()
        normal, dmin, dmax = mapping.point_descriptor_stats(
            X, self.ref_ff.desc, torch.zeros(3, device=dev), self.ref_ff.octave,
            cfg.orb.scale_factor, cfg.orb.n_levels)
        m, pt_idx = mapstate.add_points(m, X, self.ref_ff.desc, normal, dmin, dmax,
                                        k1, self.ref_frame_id, tri)
        m = mapstate.add_observations(m, k1, pt_idx, self.ref_ff.xy,
                                      self.ref_ff.octave, tri)
        both = tri & mm.valid
        m = mapstate.add_observations(m, k2, pt_idx, ff.xy[j], ff.octave[j], both)
        # BA of the two-view map, then renormalize to median depth 1: the
        # monocular gauge leaves the scale free and the BA drifts it, and
        # the points' creation-time pt_min/max_dist gates would then reject
        # every projection candidate (0 inliers right after init)
        m = local_ba(cfg, self.cam_params, m, 1)
        m = renorm_init(m, 1)

        # a fresh map: its two keyframes sit at slots 0 and 1
        self.map = m
        self._set_pose(_row(m.kf_R, 1), _row(m.kf_t, 1))
        self.R_prev, self.t_prev = self.R_cur, self.t_cur
        self.has_velocity = False
        self.state = OK
        self.last_kf_id = self.frame_id
        self.last_kf_idx = 1
        self.n_kf_host = 2
        self.last_kf_ts = ts
        # bindings: cur frame keypoint j <-> point; ref frame keypoint i
        N = ff.xy.shape[0]
        kp_pt2 = _set_drop(torch.full((N,), -1, dtype=torch.int32, device=dev),
                           torch.where(both, j, N), torch.where(both, pt_idx, -1))
        kp_pt1 = torch.where(tri, pt_idx, -1)
        self._bank_store(0, self.ref_ff, kp_pt1)
        self._bank_store(1, ff, kp_pt2)
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(m, 0, self.ref_ff)
            self.loop_closer.add_keyframe(m, 1, ff)
        n_bound, n_tri = torch.stack([torch.sum(kp_pt2 >= 0), torch.sum(tri)]).tolist()
        self.inliers_at_last_kf = n_bound
        self.init_info = dict(frame=self.frame_id, ref_frame=self.ref_frame_id,
                              used_homography=used_homography, n_points=n_tri)
        self._refresh_view()
        # first trajectory entry for the ref frame
        self.trajectory.append((self.ref_ts, np.eye(3), np.zeros(3)))

    # ------------------------------------------------------------- tracking
    def _track_frame(self, ff: FeatureFrame, ts: float):
        cfg = self.cfg
        # non-blocking poll: absorb the pending chain if it is done
        self._merge_pending(force=False)
        # constant-velocity model: T_guess = V * T_cur, V = T_cur T_prev^-1
        if self.has_velocity:
            Rpi, tpi = lie.se3_inverse(self.R_prev, self.t_prev)
            Rv, tv = lie.se3_compose(self.R_cur, self.t_cur, Rpi, tpi)
            Rg, tg = lie.se3_compose(Rv, tv, self.R_cur, self.t_cur)
        else:
            Rg, tg = self.R_cur, self.t_cur
        # search radius: tight with a warm motion model, wide right after
        # initialization or a loss
        radius = 4.0 if self.has_velocity else 30.0
        tr = tracking.track_local_map(
            self.map, ff, Rg, tg, cfg.cam_model, self.cam_params, cfg.image_hw,
            cfg.orb.scale_factor, cfg.orb.n_levels, radius_th=radius, view=self.view)
        self.map = tracking.update_point_stats(self.map, tr)
        # the frame's one read: the inlier count, with the pose that the
        # trajectory records (inlier counts are exact in float32)
        with profiling.span("host_read"):
            host = torch.cat([tr.n_inliers.to(torch.float32).reshape(1),
                              tr.R.reshape(-1), tr.t]).cpu().numpy()
        n_inl = int(host[0])
        self.last_track_inliers = n_inl
        if n_inl < cfg.min_track_inliers:
            profiling.count("track.lost")
            if self._handle_tracking_loss(ff):
                return
            self._reset()
            return
        self.lost_frames = 0
        # a successful track recovers from RECENTLY_LOST
        self.state = OK
        self.R_prev, self.t_prev = self.R_cur, self.t_cur
        self._set_pose(tr.R, tr.t, host=(host[1:10].reshape(3, 3), host[10:13]))
        self.has_velocity = True
        self.last_kp_pt = tr.kp_pt     # the viewer's FrameDrawer overlay
        self._keyframe_if_needed(ff, tr, ts, n_inl)

    def _keyframe_if_needed(self, ff: FeatureFrame, tr, ts: float, n_inl: int) -> None:
        """The keyframe decision (reference src/Tracking.cc:985-1005), counted
        by the rule that fired; localization-only mode never inserts."""
        cfg = self.cfg
        by_frames = self.frame_id - self.last_kf_id >= cfg.max_frames_between_kf
        by_inliers = n_inl < cfg.kf_inlier_ratio * max(self.inliers_at_last_kf, 1)
        if not (by_frames or by_inliers) or self.localization_only or \
                self.n_kf_host >= cfg.map_capacity.n_kf - 1:
            return
        profiling.count("kf.both" if by_frames and by_inliers else
                        "kf.max_frames" if by_frames else "kf.inlier_ratio")
        with profiling.span("keyframe"):
            self._insert_keyframe(ff, tr, ts, n_inl)

    def _insert_keyframe(self, ff: FeatureFrame, tr, ts: float, n_inl: int):
        """The keyframe frame: synchronous, or with `async_mapping` the
        insertion here and culling + window BA as a pending chain."""
        # at most one chain in flight: absorb the previous one first
        self._merge_pending(force=True)
        kp_ur = self._frame_kp_ur(ff)
        self._ensure_bank(ff)
        # add_keyframe appends at index n_kf: host-predictable, no read
        ki = self.n_kf_host
        use_async = self.cfg.async_mapping and self._async_ok
        if use_async:
            # tracking goes on against the post-insert snapshot (the new
            # keyframe and its points are visible at once, as after the
            # reference's ProcessNewKeyFrame); the per-frame pose optimizer
            # re-anchors the camera to the optimized map after the swap-in
            with profiling.span("insert_kf"):
                m, bank, _, kp_pt_new, _ = insert_kf(
                    self.cfg, self.cam_params, self.map, self.bank, ff, tr.kp_pt, tr.R, tr.t,
                    ts, self.frame_id, kp_ur)
            view = None
        else:
            m, bank, _, kp_pt_new, _, view = kf_step(
                self.cfg, self.cam_params, self.map, self.bank, ff, tr.kp_pt, tr.R, tr.t,
                ts, self.frame_id, kp_ur, ki, ba=self._window_ba())
        self.bank = bank
        self.n_kf_host += 1
        self.last_kf_ts = ts
        self.last_kf_idx = ki
        self.last_kf_id = self.frame_id
        self.inliers_at_last_kf = n_inl
        if use_async:
            self.map = m
            # the forced merge above can itself have posted a GBA (a loop
            # closure in the stages after the BA): absorb it before claiming
            # the pending slot, or it would be lost
            self._drain_pending()
            frame_id = self.frame_id
            self._post_chain(lambda m_, bank_: cull_ba(self.cfg, self.cam_params, m_,
                                                       frame_id, ki, bank_),
                             ki, "kf", (self.map, self.bank), ff=ff, ts=ts)
            self._refresh_view()
            return
        self.R_prev, self.t_prev, R_cur, t_cur = kf_pose_refresh(
            m, ki, self.R_cur, self.t_cur, self.R_prev, self.t_prev)
        self._set_pose(R_cur, t_cur)
        self.map = m
        self._post_ba_stages(ki, ff, ts, kp_pt_new, view)

    def _post_ba_stages(self, ki: int, ff: FeatureFrame, ts: float, kp_pt, view=None) -> None:
        """The stages after the window BA (`post_ba_stages`), then map
        merging or loop closing, then the GNSS stage: sync mode runs them in
        the keyframe frame, async mode at the swap-in (the reference runs
        them on its LocalMapping and LoopClosing threads).  With a stored
        Atlas session the keyframe first tries to merge, and tries a loop
        closure only if it did not (system.py:1037-1045).  The GNSS stage
        runs after them, so that a GNSS BA starts from the corrected map, and
        only when nothing is pending: a GBA that a closure posted keeps the
        slot and the GNSS BA waits for the next cadence."""
        with profiling.span("post_ba_stages"):
            self.map, self.bank, _, self.view, culled = post_ba_stages(
                self.cfg, self.cam_params, self.map, self.bank, ki, ff, kp_pt, view,
                loop_closer=self.loop_closer)
            if culled is not None:
                self._cull_keyframe(culled)
            if self.cfg.enable_loop_closing and self.loop_closer is not None:
                merged = bool(self.atlas.sessions) and map_merging.try_merge(self, ff, ki)
                if merged:
                    ki = self.last_kf_idx       # the keyframe's index in the merged map
                if merged or self.loop_closer.try_close(self, ff, ki):
                    self._refresh_view()
            if self.georef is not None and self._pending is None:
                self._gnss_keyframe_stage(ki, ts)

    def _gnss_keyframe_stage(self, ki: int, ts: float) -> None:
        """Associate the queued fix nearest in time with keyframe `ki`, update
        the Umeyama georeference, and at cadence post the GNSS-constrained BA
        (reference LocalMapping's GNSS stage, src/LocalMapping.cc:155-189).
        Reads the keyframe's pose when a fix is associated."""
        cfg = self.cfg
        best = None
        for ft, fp in self.gnss_queue:
            if abs(ft - ts) <= cfg.gnss_time_tol and \
                    (best is None or abs(ft - ts) < abs(best[0] - ts)):
                best = (ft, fp)
        self.gnss_queue = [q for q in self.gnss_queue if q[0] > ts - cfg.gnss_time_tol]
        if best is None:
            return
        self.kf_gnss[ki] = best[1]
        Rt = torch.cat([self.map.kf_R[ki].reshape(-1), self.map.kf_t[ki]]).cpu().numpy()
        self.georef.add_fix(Rt[:9].reshape(3, 3).T @ (-Rt[9:]), best[1])
        self.georef.update()
        if not self.georef.initialized or ki % max(cfg.gnss_ba_every, 1) != 0:
            return
        # the fixes pulled into the SLAM frame by the inverse georeference
        # (the map and its gauge stay in SLAM coordinates; the reference
        # optimizes in the geo frame, the same problem up to the Sim3)
        T = self.georef.transform
        R_i = T.R.numpy().T
        s_i = 1.0 / max(float(T.s), 1e-9)
        t_np = T.t.numpy()
        K = cfg.map_capacity.n_kf
        prior_pos = np.zeros((K, 3), np.float32)
        prior_w = np.zeros(K, np.float32)
        for k, fix in self.kf_gnss.items():
            prior_pos[k] = s_i * (R_i @ (fix - t_np))
            prior_w[k] = 1.0 / (cfg.gnss_sigma * s_i) ** 2
        # a pending chain, absorbed like the post-loop GBA: the per-frame
        # pose optimization re-anchors the camera to the geo-corrected map
        self._post_chain(lambda m, bank, pp, pw: gnss_ba(cfg, self.cam_params, m, ki, pp, pw,
                                                         bank),
                         ki, "gba", (self.map, self.bank, _upload(prior_pos, self.device),
                                     _upload(prior_w, self.device)))
        self.n_gnss_ba += 1

    # ------------------------------------------------------- pending chain
    def _post_chain(self, fn, ki: int, kind: str, inputs: tuple, ff=None, ts: float = 0.0):
        """Post fn(*inputs) -> optimized map as the pending chain: on the
        side stream after the current stream's work so far (on the CPU,
        inline)."""
        self.chain_counts["posted " + kind] += 1
        side = self._side_stream
        if side is None:
            self._pending = Pending(fn(*inputs), ki, kind, ff, ts, None, inputs)
            return
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            m_opt = fn(*inputs)
            done = torch.cuda.Event()
            done.record(side)
        self._pending = Pending(m_opt, ki, kind, ff, ts, done, inputs)

    def _merge_pending(self, force: bool = False) -> None:
        """Swap in the pending chain's optimized map (reference analogue:
        LocalMapping finishing its keyframe, or the GBA thread's result,
        reaching Tracking through the shared map).  Geometry from the
        snapshot, tracking counters and anything appended since from the
        live map (`merge_opt`).  `force=False` merges only a finished chain
        and never waits; `force=True` orders the current stream after the
        chain.  A "gba" merge also carries the tracker (and the inertial
        tracker's velocity) by the anchor correction, so that the next
        frames do not track a map that jumped under them; a "kf" merge runs
        the stages after the BA for its keyframe."""
        pend = self._pending
        if pend is None:
            return
        if pend.done is not None:
            if not force and not pend.done.query():
                return
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(pend.done)
            for x in pend.m_opt:
                x.record_stream(cur)
        self._pending = None
        self.chain_counts[f"merged {pend.kind} {'forced' if force else 'at a poll'}"] += 1
        m_live = self.map
        self.map = merge_opt(m_live, pend.m_opt)
        if pend.kind == "gba":
            # the tracker rides A too: T' = T A^-1
            R_A, t_A = anchor_correction(m_live, pend.m_opt)
            Rn = self.R_cur @ R_A.T
            self._set_pose(Rn, self.t_cur - Rn @ t_A)
            self.R_prev = self.R_prev @ R_A.T
            self.t_prev = self.t_prev - self.R_prev @ t_A
            self.has_velocity = False
            if hasattr(self, "frame_prior"):      # inertial tracker state
                self.frame_prior = None
                self.vel = R_A @ self.vel
                self.last_body = self._cam_to_body(self.R_cur, self.t_cur)
                self._map_updated = True
            self._refresh_view()
            return
        self._post_ba_stages(pend.ki, pend.ff, pend.ts, _row(self.bank.kp_pt, pend.ki))

    def _drain_pending(self) -> None:
        """Force-merge until nothing is pending: a "kf" merge's stages can
        close a loop and post the post-loop GBA, which is absorbed too."""
        while self._pending is not None:
            self._merge_pending(force=True)

    def _schedule_gba(self, ki: int) -> None:
        """Post the full-map GBA as the pending chain (reference
        LoopClosing::RunGlobalBundleAdjustment's detached thread)."""
        if not self.cfg.post_loop_gba:
            return
        self._post_chain(lambda m, bank: gba(self.cfg, self.cam_params, m, ki, bank),
                         ki, "gba", (self.map, self.bank))

    def _window_ba(self):
        """The keyframe step's window BA as `kf_step` takes it: None, the
        visual grid BA.  The inertial System returns its visual-inertial BA
        once the IMU is initialized."""
        return None

    def _merge_ba(self, m: mapstate.MapState, ki: int) -> mapstate.MapState:
        """The welding BA of a map merge around keyframe `ki`: the keyframe
        step's window BA (`_window_ba`), the visual one from the map's
        observation list, as JAX's `_local_ba(m, ki)`."""
        ba = self._window_ba()
        return local_ba(self.cfg, self.cam_params, m, ki) if ba is None else ba(m, ki, self.bank)

    def _cull_keyframe(self, kf_idx: int) -> None:
        """Keyframe culling removed keyframe `kf_idx` from the map and the
        keyframe database (`post_ba_stages`); this hook updates what a
        System keeps per keyframe beside them.  The monocular System keeps
        nothing there; the inertial System merges the preintegration chain
        across the culled keyframe."""

    # ----------------------------------------------------------------- loss
    def _handle_tracking_loss(self, ff) -> bool:
        """RECENTLY_LOST handling: try to relocalize against the keyframe
        database (upstream Tracking::Relocalization; the fork resets
        instead; both are kept, the reset after `reloc_patience` frames).
        Returns True if the frame was recovered or patience remains."""
        # relocalize against the best map there is
        self._drain_pending()
        # lost: widen to the full-capacity view (the local view was built
        # around a keyframe we may no longer be near); the next keyframe
        # insertion rebuilds it
        self.view = None
        if self.loop_closer is not None:
            ok, R, t = relocalization.attempt_relocalization(self, ff, self.loop_closer)
            if ok:
                self._set_pose(R, t)
                self.R_prev, self.t_prev = R, t
                self.has_velocity = False
                self.lost_frames = 0
                self.state = OK
                return True
        self.lost_frames += 1
        if self.lost_frames <= self.cfg.reloc_patience:
            self.state = RECENTLY_LOST
            self.has_velocity = False
            return True
        return False

    # ---------------------------------------------------------------- reset
    def _reset(self):
        """Lost: archive the map in the Atlas and start a fresh one
        (reference src/Tracking.cc:543-544)."""
        self.n_resets += 1
        self._archive_and_new_map()

    def _create_map_in_atlas(self):
        """Archive the current map and start a fresh one without counting a
        tracking failure (reference Tracking::CreateMapInAtlas,
        src/Tracking.cc:771-805, on timestamp anomalies)."""
        self.n_map_switches += 1
        self._archive_and_new_map()

    def _archive_and_new_map(self):
        self._drain_pending()   # archive the optimized map
        db = None
        if self.loop_closer is not None:
            # the database goes with its map; the new map starts an empty one
            db = self.loop_closer.db
            self.loop_closer.db = kdb.clear(db)
            self.loop_closer.consistent_groups = []
        self.atlas.store_session(self.map, self.bank, self.trajectory, db=db)
        self.trajectory = []
        self.state = NO_IMAGES_YET
        self.n_kf_host = 0
        self.last_kf_ts = 0.0
        self.map = mapstate.empty_map(self.cfg.map_capacity, self.device)
        self.ref_ff = None
        self.view = None
        self.has_velocity = False
        self.lost_frames = 0
        if self.bank is not None:
            self.bank = fb.empty_bank(self.bank.xy.shape[0], self.bank.xy.shape[1],
                                      self.device)
        # the GNSS state belongs to the map: a fresh SLAM frame voids the Sim3
        self.kf_gnss.clear()
        if self.georef is not None:
            self.georef = georef_mod.GeometricReferencer(min_kfs=self.cfg.gnss_min_kfs)

    # ------------------------------------------------------------------ api
    def activate_localization_mode(self) -> None:
        """Track against the frozen map; no keyframes, no mapping
        (reference System::ActivateLocalizationMode)."""
        self._drain_pending()
        self.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False

    def reset(self) -> None:
        """Public reset (reference System::Reset): archive the active map
        and start fresh."""
        self._reset()
        self.state = NO_IMAGES_YET

    @property
    def tracking_state(self) -> int:
        """Reference System::GetTrackingState."""
        return self.state

    def shutdown(self) -> None:
        """Reference System::Shutdown: absorbs the pending chain (there are
        no threads to join), waits for the device's queue and detaches the
        viewer."""
        self._drain_pending()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.viewer is not None:
            self.viewer.stop()
            self.viewer = None

    # ----------------------------------------------------------- trajectory
    @staticmethod
    def _tum_line(ts, Rwc, twc) -> str:
        q = lie.rot_to_quat(torch.as_tensor(np.asarray(Rwc), dtype=torch.float32)).numpy()
        return "%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f" % (
            ts, twc[0], twc[1], twc[2], q[1], q[2], q[3], q[0])

    def trajectory_tum(self) -> str:
        """TUM-format trajectory (ts x y z qx qy qz qw)."""
        return "\n".join(self._tum_line(*p) for p in self.trajectory) + "\n"

    def keyframe_trajectory_tum(self) -> str:
        """TUM-format keyframe trajectory (reference
        System::SaveKeyFrameTrajectoryTUM)."""
        nk = max(self.n_kf_host, 1)
        m = self.map
        kR, kt = m.kf_R[:nk].cpu().numpy(), m.kf_t[:nk].cpu().numpy()
        kts, kval = m.kf_ts[:nk].cpu().numpy(), m.kf_valid[:nk].cpu().numpy()
        lines = []
        for k in range(self.n_kf_host):
            if kval[k]:
                Rwc = kR[k].T
                lines.append(self._tum_line(kts[k], Rwc, -Rwc @ kt[k]))
        return "\n".join(lines) + "\n"
