"""Loop closing: detection, Sim3 computation and the loop correction.

Counterpart of `orbslam3_tpu/pipeline/loop_closing.py` (parity target:
upstream ORB-SLAM3 LoopClosing):
  * candidate detection through the keyframe database with covisibility
    exclusion and temporal consistency (reference KeyFrameDatabase::
    DetectNBestCandidates, src/KeyFrameDatabase.cc:602; LoopClosing::
    DetectLoop);
  * the Sim3 between the current keyframe and each accepted candidate from
    matched map points (reference Sim3Solver, ComputeSim3), the candidate
    with the most inliers winning;
  * the correction: the essential graph (spanning tree, temporal chain,
    strong covisibility pairs, every persisted loop edge) optimized over
    Sim3 vertices with the measured loop edge, 4-DoF on an IMU-initialized
    map, then map points carried by their reference keyframe's correction,
    velocities rotated, the recorded trajectory re-anchored on the host
    (reference LoopClosing::CorrectLoop, Optimizer::OptimizeEssentialGraph,
    src/Optimizer.cc:1848); the loop edge persisted and the full-map GBA
    posted as the System's pending chain.
`System` builds a `LoopCloser` for relocalization too: the keyframe database
backs both.

The port keeps keyframe features and bindings in the device feature bank
only, so a candidate's descriptors, keypoints, angles and bindings come from
the bank's rows (the JAX package reads its host dictionaries `kf_features`
and `kf_bindings`).  The Sim3 RANSAC draws its samples with the System's
generator unless `try_close(idx_fn=)` gives them (the tests inject JAX's
draw, `jax.random.PRNGKey(kf_idx)` at loop_closing.py:306).

An attempt reads back as the JAX one does: in `detect` the candidates and
the covisibility adjacency; per candidate the match count, then the Sim3's
outcome and inlier count in one transfer; after a closure the keyframes'
old and new poses for the trajectory, in one transfer.  `torch.linalg.svd`
inside the Sim3 solver checks its status on the host on a card.

The codebook is unpacked into float bits once per `LoopCloser` (65536 words:
64 MiB) and again only when `refine_vocab` changes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import sim3solver
from ..ops import lie, matching
from ..place import keyframe_db as kdb
from ..place import vocab as vocab_mod
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _on, _row, _set_at, _upload
from ..solver import pose_graph


def build_essential_graph(m: mapstate.MapState, min_covis: int = 100,
                          n_covis_edges: int = 256):
    """The essential graph's edges (reference OptimizeEssentialGraph,
    src/Optimizer.cc:1848-2179, and KeyFrame.h:86-101): the spanning tree
    (each keyframe's strongest earlier covisible one), the temporal chain,
    the `n_covis_edges` strongest covisibility pairs of weight >= min_covis,
    and every persisted loop edge.  Measurements are the current relative
    poses (s = 1).  Returns (ei, ej, eR, et, es, valid) with 2K +
    n_covis_edges + L rows.

    The covisibility pairs are the top of K^2 integer counts, where ties are
    the rule: a stable descending sort keeps the lower flat index first, as
    `lax.top_k` does (T2)."""
    K = m.kf_R.shape[0]
    dev = m.kf_R.device
    W = mapstate.covisibility_matrix(m)
    ids = torch.arange(K, device=dev)
    valid_pair = m.kf_valid[:, None] & m.kf_valid[None, :] & (ids[:, None] != ids[None, :])
    W = torch.where(valid_pair, W, -1.0)
    # spanning tree: parent = strongest earlier covisible (the first maximum)
    Wb = torch.where(ids[None, :] < ids[:, None], W, -1.0)
    parent = torch.argmax(Wb, dim=1)
    tree_ok = (torch.amax(Wb, dim=1) > 0) & m.kf_valid & (ids > 0)
    # temporal chain (k, k - 1)
    prev = torch.clamp_min(ids - 1, 0)
    chain_ok = m.kf_valid & (ids > 0) & m.kf_valid[prev] & (ids < m.n_kf)
    # strong covisibility pairs, lower triangle, the top n_covis_edges
    vals, flat = torch.sort(Wb.reshape(-1), descending=True, stable=True)
    vals, flat = vals[:n_covis_edges], flat[:n_covis_edges]
    cv_ok = vals >= float(min_covis)
    # persisted loop / merge edges (reference KeyFrame::mspLoopEdges): every
    # past closure's pair re-enters every later essential graph
    li = torch.clamp(m.loop_i, 0, max(K - 1, 0)).long()
    lj = torch.clamp(m.loop_j, 0, max(K - 1, 0)).long()
    l_ok = m.loop_valid & (m.loop_i >= 0) & (m.loop_j >= 0) & m.kf_valid[li] & m.kf_valid[lj]
    ei = torch.cat([ids, ids, flat // K, li])
    ej = torch.cat([prev, parent, flat % K, lj])
    evalid = torch.cat([chain_ok, tree_ok, cv_ok, l_ok])
    # measurement S_ij = S_i S_j^-1 from the current poses (s = 1)
    Ri, ti, Rj, tj = m.kf_R[ei], m.kf_t[ei], m.kf_R[ej], m.kf_t[ej]
    Rm = Ri @ Rj.transpose(-1, -2)
    tm = ti - lie._mv(Rm, tj)
    es = torch.ones(ei.shape[0], dtype=torch.float32, device=dev)
    return ei.to(torch.int32), ej.to(torch.int32), Rm, tm, es, evalid


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    # 65536 words, the JAX package's default: its recall study over 1024
    # aliased places chose it over 32768
    n_words: int = 65536
    vocab: str = "trained"          # "trained" (data/vocab_*.npy) | "seed"
    min_common_words: int = 5
    consistency_needed: int = 3     # consecutive consistent detections
    min_sim3_matches: int = 20
    min_sim3_inliers: int = 20
    min_kf_gap: int = 12            # candidate must be this many keyframes old
    pose_graph_iters: int = 20


class LoopCloser:
    """Host-side place-recognition module attached to a System; its tensors
    live on `device`."""

    def __init__(self, cfg: LoopConfig, n_kf_capacity: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self._set_codebook(vocab_mod.codebook_tensor(
            vocab_mod.load_codebook(cfg.n_words, prefer_trained=(cfg.vocab == "trained")),
            self.device))
        self.db = kdb.KeyframeDB.create(n_kf_capacity, cfg.n_words, self.device)
        # consistency chains: list of ((K,) bool covisibility-group mask,
        # count) (reference LoopClosing::DetectLoop mvConsistentGroups)
        self.consistent_groups: list[tuple[np.ndarray, int]] = []
        self.n_loops_closed = 0
        # what the last closure did: keyframe, winning candidate, matches,
        # Sim3 inliers
        self.last_closure: dict | None = None

    def _set_codebook(self, codebook: torch.Tensor) -> None:
        self.codebook = codebook
        self._unpacked = vocab_mod.unpack_codebook(codebook)

    def _bow(self, desc, valid):
        """(BoW vector (V,), word ids (N,)) of one frame's descriptors."""
        w = vocab_mod.assign_words(desc, self._unpacked)
        return vocab_mod.bow_vector(w, valid, self.cfg.n_words), w

    def _covis_row(self, m: mapstate.MapState, kf_idx):
        return mapstate.covisibility_weights(m, kf_idx)

    def _detect_jit(self, m: mapstate.MapState, db: kdb.KeyframeDB, bow, kf_idx):
        """DetectNBestCandidates with the covisibility adjacency that the
        group consistency needs.  Returns (cand (3,), score (3,), covis
        (K, K) bool)."""
        K = m.kf_R.shape[0]
        W = mapstate.covisibility_matrix(m)
        ids = torch.arange(K, device=W.device)
        covis = (W >= 15.0) & (ids[:, None] != ids[None, :]) & \
            m.kf_valid[:, None] & m.kf_valid[None, :]
        exclude = mapstate._row(covis, kf_idx) | (ids > kf_idx - self.cfg.min_kf_gap)
        cand, score = kdb.detect_candidates(db, bow, exclude, covis, n_best=3)
        return cand, score, covis

    # ------------------------------------------------------------- keyframe
    def add_keyframe(self, m, kf_idx, ff) -> None:
        """Register keyframe `kf_idx` (a Python int or a 0-d device tensor)
        with the BoW vector of its features.  No host read."""
        bow, _ = self._bow(ff.desc, ff.valid)
        self.db = kdb.add(self.db, kf_idx, bow)

    # -------------------------------------------------------- online vocab
    def refine_vocab(self, kf_features: dict, iters: int = 4) -> None:
        """Online codebook refinement (the analogue of DBoW2's offline
        k-means training, on the session's own imagery): k-majority refine
        the codebook over every given keyframe's descriptors ({keyframe
        index: FeatureFrame}), then re-encode the database so that stored
        BoW vectors and later queries live in the same word space.  A
        map-sized operation, for between sessions."""
        if not kf_features:
            return
        desc = torch.cat([f.desc for f in kf_features.values()])
        valid = torch.cat([f.valid for f in kf_features.values()])
        self._set_codebook(vocab_mod.kmeans_refine(self.codebook, desc, valid, iters=iters))
        self.db = kdb.clear(self.db)
        for k, f in kf_features.items():
            self.add_keyframe(None, k, f)
        self.consistent_groups = []

    # ------------------------------------------------------------ detection
    def detect(self, m: mapstate.MapState, kf_idx: int, ff) -> list:
        """The consistency-accepted loop-candidate keyframe indices, the
        best-scored first (empty when none).

        Candidates come from DetectNBestCandidates (covisibility-group
        accumulated TF-IDF scores); acceptance needs the reference's
        covisibility-consistency chains (LoopClosing::DetectLoop): a
        candidate's covisibility group must intersect a group detected at
        each of the last `consistency_needed` keyframes.  Every accepted
        candidate is returned, because the geometric check then tries each."""
        bow, _ = self._bow(ff.desc, ff.valid)
        cand_idx, _, covis = self._detect_jit(m, self.db, bow, kf_idx)
        cand_np = cand_idx.cpu().numpy()
        covis_np = covis.cpu().numpy()
        accepted: list[int] = []
        new_groups: list[tuple[np.ndarray, int]] = []
        prev_masks = np.stack([g for g, _ in self.consistent_groups]) \
            if self.consistent_groups else None
        prev_counts = np.asarray([c for _, c in self.consistent_groups], np.int64)
        for cand in cand_np:
            cand = int(cand)
            if cand < 0:
                continue
            group = covis_np[cand].copy()
            group[cand] = True
            count = 0
            if prev_masks is not None:
                overlap = (prev_masks & group).any(axis=1)
                if overlap.any():
                    count = int(prev_counts[overlap].max()) + 1
            new_groups.append((group, count))
            # `count` is the reference's nCurrentConsistency (prior count +
            # 1); with the default 3 a loop needs 4 consecutive consistent
            # detections, as upstream
            if count >= self.cfg.consistency_needed:
                accepted.append(cand)
        self.consistent_groups = new_groups
        return accepted

    # ------------------------------------------------------------- closure
    def try_close(self, system, ff, kf_idx: int, idx_fn=None) -> bool:
        """The whole loop attempt for the just-inserted keyframe `kf_idx`:
        detection, the database's registration of the keyframe, and, with
        accepted candidates, a Sim3 RANSAC against each (descriptor matches
        between the keyframes' bound keypoints); the candidate with the most
        Sim3 inliers wins (reference ComputeSim3 tries every
        enough-consistent candidate) and the loop is corrected.  Mutates
        the system's map and tracker on success.  Returns True if a loop
        was closed.  `idx_fn(kf_idx, valid)` gives a candidate's (128, 3)
        Sim3 sample indices over the match mask `valid`; absent, they are
        drawn with the system's generator."""
        m = system.map
        cands = self.detect(m, kf_idx, ff)
        self.add_keyframe(m, kf_idx, ff)
        bank = system.bank
        if not cands or bank is None:
            return False
        cur_kp_pt = _row(bank.kp_pt, kf_idx)
        # fixed-scale Sim3 (an SE3) where the map's scale is observable: an
        # IMU-initialized or stereo map (reference mbFixScale,
        # src/LoopClosing.cc:45)
        fix_scale = bool(getattr(system, "imu_initialized", False)) or \
            system.cfg.stereo_bf > 0.0
        P = m.pt_xyz.shape[0]
        pt_cur = torch.clamp(cur_kp_pt, 0, P - 1).long()
        best = None          # (n_inliers, cand, res, n_matches)
        for cand in cands:
            cand_ff = fb.frame_view(bank, cand)
            cand_kp_pt = _row(bank.kp_pt, cand)
            mm = matching.match_nn(
                ff.desc, cand_ff.desc,
                mask=(cur_kp_pt >= 0)[:, None] & (cand_kp_pt >= 0)[None, :] &
                ff.valid[:, None] & cand_ff.valid[None, :],
                max_dist=matching.TH_LOW, nn_ratio=0.75, angles_a=ff.angle,
                angles_b=cand_ff.angle, check_rotation=True)
            n_matches = int(torch.sum(mm.valid))
            if n_matches < self.cfg.min_sim3_matches:
                continue
            j = torch.clamp_min(mm.idx, 0).long()
            pt_cand = torch.clamp(cand_kp_pt[j], 0, P - 1).long()
            res_c = sim3solver.solve_sim3(
                m.pt_xyz[pt_cand], m.pt_xyz[pt_cur], mm.valid, cand_ff.xy[j], ff.xy,
                _row(m.kf_R, cand), _row(m.kf_t, cand), _row(m.kf_R, kf_idx),
                _row(m.kf_t, kf_idx), system.cfg.cam_model, system.cam_params,
                min_inliers=self.cfg.min_sim3_inliers, fix_scale=fix_scale,
                idx=None if idx_fn is None else idx_fn(kf_idx, mm.valid),
                generator=system.generator)
            ok, n_inl = torch.stack([res_c.success.to(torch.int32),
                                     res_c.n_inliers.to(torch.int32)]).tolist()
            if ok and (best is None or n_inl > best[0]):
                best = (n_inl, cand, res_c, n_matches)
        if best is None:
            return False
        n_inl, cand, res, n_matches = best
        # solve_sim3(X_cand, X_cur) maps current-camera coordinates into the
        # loop keyframe's camera; the correction wants loop -> current
        R_lc, t_lc, s_lc = lie.sim3_inverse(res.R12, res.t12, res.s12)
        res = res._replace(R12=R_lc, t12=t_lc, s12=s_lc)
        self._correct_loop(system, kf_idx, cand, res)
        # persist the loop edge after the correction (reference
        # KeyFrame::AddLoopEdge): later essential graphs keep this seam
        system.map = mapstate.add_loop_edge(system.map, kf_idx, cand, res.R12, res.t12,
                                            res.s12)
        # the full-map GBA, as the System's pending chain (reference
        # LoopClosing::RunGlobalBundleAdjustment's detached thread)
        system._schedule_gba(kf_idx)
        self.n_loops_closed += 1
        self.consistent_groups = []
        self.last_closure = dict(kf=kf_idx, cand=cand, n_matches=n_matches, n_inliers=n_inl)
        return True

    # ------------------------------------------------------------ correction
    def _correct_loop(self, system, kf_cur: int, kf_loop: int, sim3: sim3solver.Sim3Result):
        """Essential-graph optimization and point transport."""
        # exact covisibility for the graph: the maintained incidence
        # over-approximates once fusion invalidates single observations
        system.map = mapstate.rebuild_incidence(system.map)
        m = system.map
        K = m.kf_R.shape[0]
        dev = m.kf_R.device
        # vertices: the current camera poses with s = 1; edges: the essential
        # graph and the measured loop edge (cur, loop), S_cl = sim3
        ei, ej, eR, et, es, evalid = build_essential_graph(m)
        one_i = lambda v: _on(v, torch.int32, dev).reshape(1)
        ei, ej = torch.cat([ei, one_i(kf_cur)]), torch.cat([ej, one_i(kf_loop)])
        eR = torch.cat([eR, sim3.R12[None]])
        et = torch.cat([et, sim3.t12[None]])
        es = torch.cat([es, sim3.s12.reshape(1)])
        evalid = torch.cat([evalid, torch.ones(1, dtype=torch.bool, device=dev)])
        # pre-correct the current keyframe: S_cur := S_meas o S_loop
        # (reference CorrectLoop corrects the current window rigidly first)
        one = torch.ones((), dtype=torch.float32, device=dev)
        Rcorr, tcorr, scorr = lie.sim3_compose(sim3.R12, sim3.t12, sim3.s12,
                                               _row(m.kf_R, kf_loop), _row(m.kf_t, kf_loop), one)
        Rv = _set_at(m.kf_R, kf_cur, Rcorr)
        tv = _set_at(m.kf_t, kf_cur, tcorr)
        sv = _set_at(torch.ones(K, dtype=torch.float32, device=dev), kf_cur, scorr)
        fixed = _set_at(_set_at(torch.zeros(K, dtype=torch.bool, device=dev), kf_loop, True),
                        0, True)
        # an IMU-initialized map keeps scale and gravity: a yaw + translation
        # graph (reference OptimizeEssentialGraph4DoF, VertexPose4DoF)
        inertial = bool(getattr(system, "imu_initialized", False))
        dof = _upload(np.asarray(pose_graph.DOF4_MASK, np.float32), dev) if inertial else None
        res = pose_graph.optimize_pose_graph(
            Rv, tv, sv, fixed=fixed, valid=m.kf_valid, e_i=ei, e_j=ej, e_R=eR, e_t=et,
            e_s=es, e_valid=evalid, e_weight=torch.ones(ei.shape[0], device=dev),
            iterations=self.cfg.pose_graph_iters, dof_mask=dof)
        # points ride their reference keyframe's correction:
        # X' = S_new^-1 (S_old (X))
        ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
        Xc = lie.se3_apply(m.kf_R[ref], m.kf_t[ref], m.pt_xyz)
        s_new = res.s[ref]
        X_new = lie.sim3_apply(*lie.sim3_inverse(res.R[ref], res.t[ref], s_new), Xc)
        pt_scale = 1.0 / torch.clamp_min(s_new, 1e-9)
        # world velocities ride each keyframe's correction, linear part
        # (1 / s_k) R_new_k^T R_old_k; biases are frame-invariant
        R_a = torch.einsum("kji,kjl->kil", res.R, m.kf_R)
        s_c = torch.clamp_min(res.s, 1e-9)
        system.map = m._replace(
            kf_R=res.R, kf_t=res.t / s_c[:, None],
            kf_vel=torch.einsum("kij,kj->ki", R_a, m.kf_vel) / s_c[:, None],
            pt_xyz=X_new, pt_min_dist=m.pt_min_dist * pt_scale,
            pt_max_dist=m.pt_max_dist * pt_scale)
        if system.trajectory:
            _reanchor_trajectory(system, m, res)
        # the GNSS georeference's window holds pre-correction positions
        if getattr(system, "georef", None) is not None:
            system.georef._slam.clear()
            system.georef._gnss.clear()
        # the tracker follows the corrected current keyframe
        R_cur, t_cur = _row(system.map.kf_R, kf_cur), _row(system.map.kf_t, kf_cur)
        system._set_pose(R_cur, t_cur)
        system.R_prev, system.t_prev = R_cur, t_cur
        system.has_velocity = False
        if hasattr(system, "frame_prior"):   # inertial tracker state
            # the VI prior is expressed in the pre-correction world
            system.frame_prior = None
            system._map_updated = True
            # the tracker's velocity rides the current keyframe's correction.
            # JAX reads the keyframe's stored velocity instead, which the
            # inertial System writes only after the keyframe step that closed
            # the loop: zero, so its tracker restarts from rest (ROADMAP queue 3)
            system.vel = _row(R_a, kf_cur) @ system.vel / _row(s_c, kf_cur)
            system.last_body = system._cam_to_body(R_cur, t_cur)


def _reanchor_trajectory(system, m: mapstate.MapState, res) -> None:
    """Correct the recorded per-frame trajectory segment by segment: each
    frame rides the world correction A_k = S_new_k^-1 S_old_k of the last
    keyframe at or before its timestamp (the reference exports frames
    relative to corrected reference keyframes, Tracking::
    mlRelativeFramePoses).  One read of the keyframes' old and new poses."""
    K = m.kf_R.shape[0]
    host = torch.cat([m.n_kf.reshape(1).to(torch.float32), m.kf_ts, m.kf_R.reshape(-1),
                      m.kf_t.reshape(-1), res.R.reshape(-1), res.t.reshape(-1),
                      res.s]).cpu().numpy()
    nk = int(host[0])
    o = 1 + K
    kf_ts = host[1:o][:nk]
    R_old = host[o:o + 9 * K].reshape(K, 3, 3)[:nk]
    t_old = host[o + 9 * K:o + 12 * K].reshape(K, 3)[:nk]
    Rn = host[o + 12 * K:o + 21 * K].reshape(K, 3, 3)[:nk]
    tn = host[o + 21 * K:o + 24 * K].reshape(K, 3)[:nk]
    sn = host[o + 24 * K:o + 25 * K][:nk]
    traj_ts = np.asarray([e[0] for e in system.trajectory])
    seg = np.clip(np.searchsorted(kf_ts, traj_ts, side="right") - 1, 0, nk - 1)
    # A = S_new_k^-1 S_old_k with S_old's s = 1: (R_a, t_a, s_a = 1 / s_new)
    s_a = 1.0 / np.maximum(sn[seg], 1e-9)
    R_inv = np.transpose(Rn[seg], (0, 2, 1))
    t_inv = -s_a[:, None] * np.einsum("fij,fj->fi", R_inv, tn[seg])
    R_a = np.einsum("fij,fjk->fik", R_inv, R_old[seg])
    t_a = s_a[:, None] * np.einsum("fij,fj->fi", R_inv, t_old[seg]) + t_inv
    Rwc = np.stack([e[1] for e in system.trajectory])
    twc = np.stack([e[2] for e in system.trajectory])
    R_new = np.einsum("fij,fjk->fik", R_a, Rwc)
    t_new = s_a[:, None] * np.einsum("fij,fj->fi", R_a, twc) + t_a
    system.trajectory = [(ts_, R_new[i], t_new[i])
                         for i, (ts_, _, _) in enumerate(system.trajectory)]
