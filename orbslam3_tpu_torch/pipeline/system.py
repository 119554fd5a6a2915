"""System facade: the monocular SLAM engine loop.

Counterpart of `orbslam3_tpu/pipeline/system.py` (parity target: reference
System + Tracking state machine, src/System.cc, src/Tracking.cc):
  * state machine NO_IMAGES_YET -> NOT_INITIALIZED -> OK / RECENTLY_LOST
    (include/Tracking.h:119-127),
  * MonocularInitialization: two frames with enough keypoints, window
    matching, two-view reconstruction, the initial map with median-depth
    normalization and a two-keyframe BA (src/Tracking.cc:566-768),
  * per frame: motion-model prediction -> TrackLocalMap -> keyframe
    decision -> the synchronous keyframe frame (insertion, triangulation,
    point culling, window BA, fusion, keyframe culling, compaction),
  * loss: every lost frame tries to relocalize against the keyframe
    database (upstream Tracking::Relocalization); RECENTLY_LOST for
    `reloc_patience` frames, then the map is archived in the Atlas and a
    fresh one started (src/Tracking.cc:543-544),
  * timestamp failsafes (src/Tracking.cc:383-395).

The keyframe programs (`System._insert_kf`, `_cull`, `_local_ba`,
`_kf_step`, `_kf_pose_refresh`, `_remap_bindings` and the map stages of
`_post_ba_stages`) are module-level functions of the configuration, the
camera parameters and the state they act on; the `System` class drives
them.  Each keyframe's features and bindings live in the device feature
bank only (the JAX class also mirrors them in host dictionaries).

With `enable_relocalization` (true by default, as in the JAX package) the
`System` builds a `loop_closing.LoopCloser`: the 65536-word vocabulary and
the keyframe database, fed with both initial keyframes and with every
inserted keyframe, erased of a culled keyframe, archived with the map's Atlas
session, and queried by `relocalization.attempt_relocalization` on every
lost frame.

Not ported yet, and refused by `System` when the configuration asks for
them: asynchronous mapping, loop closing (its detection half is in
`loop_closing.py`, the Sim3 correction is not), GNSS, the sharded BA,
non-pinhole cameras and stereo.

Everything stays on the device except where the reference itself reads a
value back: per frame the inlier count (read together with the pose that
the trajectory records); per initialization attempt the keypoint count, the
match count, the outcome and the median depth; in the keyframe frame the
redundancy flags of keyframe culling and the capacity check of slot
compaction, both in `post_ba_stages`; per relocalization attempt the
database's scores and the batch's decision.  Feeding the database reads
nothing.  Keyframe indices are host ints, as the JAX class mirrors them on
the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..features import extractor
from ..features.extractor import FeatureFrame, OrbParams
from ..geometry import twoview
from ..ops import lie, matching
from ..slam_map import atlas as atlas_mod
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _row, _set_drop, _set_drop_last
from . import fusion, loop_closing, mapping, relocalization, tracking
from ..place import keyframe_db as kdb

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """The JAX package's `SlamConfig` (system.py:52-121) with the same
    fields and defaults.  `System` refuses the flags of parts that are not
    ported yet (`_check_ported`)."""
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
    enable_relocalization: bool = True   # keyframe database + relocalization on loss
    reloc_patience: int = 10   # frames in RECENTLY_LOST before map reset
    # timestamp failsafes (reference src/Tracking.cc:383-395): a frame older
    # than its predecessor archives the map and starts a fresh one; a gap
    # longer than image_timeout declares the track lost
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
                   bank: fb.FeatureBank, ki: int, ff: FeatureFrame, kp_pt, view,
                   loop_closer: Optional[loop_closing.LoopCloser] = None):
    """The map stages after the window BA (system.py:991-1036): fusion into
    keyframe `ki` every `fuse_every_n_kf` keyframes, keyframe culling at
    ki > 6 and ki % 4 == 0, and slot compaction at ki % 8 == 0 above 85%
    of the point or observation capacity.  Returns (map, bank, kp_pt of
    `ki`, view); the view is rebuilt around `ki` if a stage changed the
    map.  With a `loop_closer` its keyframe database follows the map: a
    culled keyframe is erased from it (reference KeyFrame::SetBadFlag ->
    KeyFrameDatabase::erase, src/KeyFrameDatabase.cc:66: a culled keyframe
    must never come back as a candidate with its frozen pose) and keyframe
    `ki` is registered at the end, which is the JAX stage's relocalization-
    only mode.  Loop detection and closure (queue 1 item 7) and the GNSS
    stage (item 9) are not ported yet and are left out."""
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
            if loop_closer is not None:
                loop_closer.db = kdb.erase(loop_closer.db, reds[0])
            dirty = True
    # slot reclamation near capacity
    if ki % 8 == 0:
        cap = cfg.map_capacity
        if int(m.n_pt) > 0.85 * cap.n_pt or int(m.n_obs) > 0.85 * cap.n_obs:
            m, remap = mapstate.compact(m)
            kp_pt = remap_bindings(kp_pt, remap)
            bank = bank._replace(kp_pt=remap_bindings(bank.kp_pt, remap))
            dirty = True
    if loop_closer is not None:
        loop_closer.add_keyframe(m, ki, ff)
    if dirty or view is None:
        view = local_view(cfg, m, ki)
    return m, bank, kp_pt, view


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


def _check_ported(cfg: SlamConfig) -> None:
    """Refuse a configuration that asks for a part not ported yet."""
    asked = [
        (cfg.async_mapping, "async_mapping (the pending chain, ROADMAP queue 1 item 4)"),
        (cfg.enable_loop_closing, "enable_loop_closing (the Sim3 correction, queue 1 item 7)"),
        (cfg.enable_gnss, "enable_gnss (queue 1 item 9)"),
        (cfg.ba_mesh_shards > 1, "ba_mesh_shards > 1 (the sharded BA, queue 1 item 10)"),
        (cfg.cam_model != "pinhole", f"cam_model {cfg.cam_model!r} (queue 1 item 8)"),
        (cfg.stereo_bf > 0.0, "stereo_bf > 0 (stereo, queue 1 item 8)"),
    ]
    for flag, what in asked:
        if flag:
            raise NotImplementedError(f"not ported yet: {what}")


class System:
    """Host-side orchestrator.  One instance per SLAM run.  All state
    tensors live on `device`: the first CUDA device unless the caller names
    another (`"cpu"` runs the plain versions of the kernels)."""

    def __init__(self, config: SlamConfig, device=None, seed: int = 42):
        _check_ported(config)
        self.cfg = config
        self.device = torch.device("cuda", 0) if device is None else torch.device(device)
        dev = self.device
        self.cam_params = torch.tensor(config.cam_params, dtype=torch.float32, device=dev)
        self.state = NO_IMAGES_YET
        self.map = mapstate.empty_map(config.map_capacity, dev)
        self.frame_id = -1
        # draws the RANSAC samples of two-view initialization and of
        # relocalization
        self.generator = torch.Generator(device=dev)
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

    # ------------------------------------------------------------- frontend
    def _extract(self, img) -> FeatureFrame:
        return extractor.extract(torch.as_tensor(img).to(self.device), self.cfg.orb)

    def _ensure_bank(self, ff: FeatureFrame):
        if self.bank is None or self.bank.xy.shape[1] != ff.capacity:
            self.bank = fb.empty_bank(self.cfg.map_capacity.n_kf, ff.capacity, self.device)

    def _bank_store(self, kf_idx: int, ff: FeatureFrame, kp_pt):
        self._ensure_bank(ff)
        self.bank = fb.set_frame(self.bank, kf_idx, ff, kp_pt)

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
    def track_monocular(self, img, ts: float, features: Optional[FeatureFrame] = None):
        """Process one frame.  Returns (state, (Rwc, twc) in numpy or None).

        `img`: (H, W) grayscale uint8 (numpy or tensor).  `features` may be
        supplied directly (tests, external front ends), on the system's
        device; otherwise they are extracted from `img`.
        """
        self.frame_id += 1
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
        ff = features if features is not None else self._extract(img)

        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            self._initialize(ff, ts)
        elif self.state in (OK, RECENTLY_LOST):
            self._track_frame(ff, ts)

        out = None
        if self.state == OK:
            # record camera-to-world pose
            R_cw, t_cw = self._pose_numpy()
            Rwc = R_cw.T
            twc = -Rwc @ t_cw
            self.trajectory.append((ts, Rwc, twc))
            out = (Rwc, twc)
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
        res = twoview.reconstruct(self.ref_ff.xy, ff.xy[j], mm.valid, self.cam_params,
                                  generator=self.generator)
        success, used_h = torch.stack([res.success, res.used_homography]).tolist()
        if not success:
            return
        self._create_initial_map(ff, mm, res, ts, used_homography=used_h)

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
        host = torch.cat([tr.n_inliers.to(torch.float32).reshape(1),
                          tr.R.reshape(-1), tr.t]).cpu().numpy()
        n_inl = int(host[0])
        self.last_track_inliers = n_inl
        if n_inl < cfg.min_track_inliers:
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

        # keyframe decision (reference src/Tracking.cc:985-1005);
        # localization-only mode never inserts
        need_kf = (self.frame_id - self.last_kf_id >= cfg.max_frames_between_kf) or \
            (n_inl < cfg.kf_inlier_ratio * max(self.inliers_at_last_kf, 1))
        if need_kf and not self.localization_only and \
                self.n_kf_host < cfg.map_capacity.n_kf - 1:
            self._insert_keyframe(ff, tr, ts, n_inl)

    def _insert_keyframe(self, ff: FeatureFrame, tr, ts: float, n_inl: int):
        """The synchronous keyframe frame."""
        kp_ur = self._frame_kp_ur(ff)
        self._ensure_bank(ff)
        # add_keyframe appends at index n_kf: host-predictable, no read
        ki = self.n_kf_host
        m, bank, _, kp_pt_new, _, view = kf_step(
            self.cfg, self.cam_params, self.map, self.bank, ff, tr.kp_pt, tr.R, tr.t,
            ts, self.frame_id, kp_ur, ki)
        self.n_kf_host += 1
        self.last_kf_ts = ts
        self.last_kf_idx = ki
        self.last_kf_id = self.frame_id
        self.inliers_at_last_kf = n_inl
        self.R_prev, self.t_prev, R_cur, t_cur = kf_pose_refresh(
            m, ki, self.R_cur, self.t_cur, self.R_prev, self.t_prev)
        self._set_pose(R_cur, t_cur)
        self.map, self.bank, _, self.view = post_ba_stages(
            self.cfg, self.cam_params, m, bank, ki, ff, kp_pt_new, view,
            loop_closer=self.loop_closer)

    # ----------------------------------------------------------------- loss
    def _handle_tracking_loss(self, ff) -> bool:
        """RECENTLY_LOST handling: try to relocalize against the keyframe
        database (upstream Tracking::Relocalization; the fork resets
        instead; both are kept, the reset after `reloc_patience` frames).
        Returns True if the frame was recovered or patience remains."""
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

    # ------------------------------------------------------------------ api
    def activate_localization_mode(self) -> None:
        """Track against the frozen map; no keyframes, no mapping
        (reference System::ActivateLocalizationMode)."""
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
        """Reference System::Shutdown.  The synchronous system has no
        pending work and no threads: waits for the device's queue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
