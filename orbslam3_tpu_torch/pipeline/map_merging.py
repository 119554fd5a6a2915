"""Cross-session map merging (the multi-session Atlas).

Counterpart of `orbslam3_tpu/pipeline/map_merging.py` (parity target:
upstream ORB-SLAM3's map-merge path, dead code in the fork): when place
recognition in the current map hits a keyframe of an archived map, the Sim3
between the two maps from matched map points (Sim3Solver), the current map
welded into the old map's frame (the Atlas merge and a welding BA over the
seam), and tracking continued in the merged map.

The archived session's features and bindings come from its feature bank's
rows (JAX reads its host dictionaries); a culled or missing candidate row is
JAX's absent dictionary entry.  The Sim3 RANSAC draws its samples with the
System's generator unless `idx_fn` gives them (the tests inject JAX's draw
under `jax.random.PRNGKey(1000 + kf_idx)`, map_merging.py:78).

A merge reads back: per session the database's best candidate (index,
score and validity in one transfer), the match count, the Sim3's outcome
and inliers in one transfer, the two maps' counters in `atlas.merge_maps`,
and after the weld the world Sim3 with the merged keyframes' validity, for
the trajectory and the database's rebuild.  `torch.linalg.svd` inside the
Sim3 solver checks its status on the host on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import sim3solver
from ..ops import lie, matching
from ..place import keyframe_db as kdb
from ..slam_map import atlas as atlas_mod
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _row


def try_merge(system, ff, kf_idx: int, min_matches: int = 25, min_inliers: int = 20,
              idx_fn=None) -> bool:
    """Weld the current map into an archived session.

    Called at keyframe insertion when sessions are stored.  On success the
    merged map replaces `system.map` (the old session's frame is
    authoritative), the session is consumed, `system.last_merge` says what
    was merged, and True is returned.  `idx_fn(kf_idx, valid)` gives the
    (128, 3) Sim3 sample indices over the match mask `valid`; absent, they
    are drawn with the system's generator."""
    lc = system.loop_closer
    if lc is None or not system.atlas.sessions or system.bank is None:
        return False
    bow, _ = lc._bow(ff.desc, ff.valid)
    cur_kp_pt = _row(system.bank.kp_pt, kf_idx)

    for si, sess in enumerate(system.atlas.sessions):
        if sess.db is None or sess.bank is None:
            continue
        scores, _ = kdb.query(sess.db, bow)
        c = torch.argmax(scores)
        cand, score, cand_ok = torch.stack([
            c.to(torch.float32), _row(scores, c),
            _row(sess.map.kf_valid, c).to(torch.float32)]).tolist()
        cand = int(cand)
        if score <= 0 or not cand_ok:
            continue
        cand_ff = fb.frame_view(sess.bank, cand)
        cand_kp_pt = _row(sess.bank.kp_pt, cand)
        mm = matching.match_nn(
            ff.desc, cand_ff.desc,
            mask=(cur_kp_pt >= 0)[:, None] & (cand_kp_pt >= 0)[None, :] &
            ff.valid[:, None] & cand_ff.valid[None, :],
            max_dist=matching.TH_LOW, nn_ratio=0.75, angles_a=ff.angle,
            angles_b=cand_ff.angle, check_rotation=True)
        n_matches = int(torch.sum(mm.valid))
        if n_matches < min_matches:
            continue

        m_old, m_cur = sess.map, system.map
        j = torch.clamp_min(mm.idx, 0).long()
        pt_cur = torch.clamp(cur_kp_pt, 0, m_cur.pt_xyz.shape[0] - 1).long()
        pt_old = torch.clamp(cand_kp_pt[j], 0, m_old.pt_xyz.shape[0] - 1).long()
        # welding an IMU-initialized (metric) or stereo map must be rigid: a
        # free scale would break the preintegrated factors' metric dP / dV
        # (reference MergeLocal2 / mbFixScale)
        fix_scale = bool(getattr(system, "imu_initialized", False)) or \
            system.cfg.stereo_bf > 0.0
        res = sim3solver.solve_sim3(
            m_old.pt_xyz[pt_old], m_cur.pt_xyz[pt_cur], mm.valid, cand_ff.xy[j], ff.xy,
            _row(m_old.kf_R, cand), _row(m_old.kf_t, cand), _row(m_cur.kf_R, kf_idx),
            _row(m_cur.kf_t, kf_idx), system.cfg.cam_model, system.cam_params,
            min_inliers=min_inliers, fix_scale=fix_scale,
            idx=None if idx_fn is None else idx_fn(kf_idx, mm.valid),
            generator=system.generator)
        ok, n_inl = torch.stack([res.success.to(torch.int32),
                                 res.n_inliers.to(torch.int32)]).tolist()
        if not ok:
            continue

        # the camera Sim3 (current camera -> old camera) as a world Sim3
        # (current world -> old world): S_w = T_oldcam->oldworld o S o
        # T_curworld->curcam
        one = torch.ones((), dtype=torch.float32, device=system.device)
        Rw, tw, sw = lie.sim3_compose(*lie.sim3_inverse(_row(m_old.kf_R, cand),
                                                        _row(m_old.kf_t, cand), one),
                                      res.R12, res.t12, res.s12)
        Rw, tw, sw = lie.sim3_compose(Rw, tw, sw, _row(m_cur.kf_R, kf_idx),
                                      _row(m_cur.kf_t, kf_idx), one)
        merged, kf_off, pt_off = atlas_mod.merge_maps(m_old, m_cur, Rw, tw, sw,
                                                      system.cfg.map_capacity)
        if merged is None:
            return False
        nk = kf_off + system.n_kf_host
        system.bank = atlas_mod.splice_banks(sess.bank, system.bank, merged.kf_valid, kf_off,
                                             system.n_kf_host, pt_off)
        system.map = merged
        system.n_kf_host = nk
        system.last_kf_idx = kf_idx + kf_off
        # the current session's keyframe indices moved by kf_off: the
        # inertial preintegration chain and the GNSS anchors follow
        if hasattr(system, "preint_kf_pairs"):
            system.preint_kf_pairs = [(a + kf_off, b + kf_off)
                                      for a, b in system.preint_kf_pairs]
        if system.kf_gnss:
            system.kf_gnss = {k + kf_off: v for k, v in system.kf_gnss.items()}
        if system.georef is not None:
            # the SLAM -> geo Sim3 was fitted in the pre-merge world frame;
            # the window starts again
            system.georef._slam.clear()
            system.georef._gnss.clear()
            system.georef.transform = None
        # the welding BA over the seam (reference LocalBundleAdjustment's
        # welding variant, src/Optimizer.cc:3156-3446): the window around
        # the weld keyframe spans both sessions through the fused observations
        system.map = system._merge_ba(system.map, system.last_kf_idx)
        # the weld persists as a merge edge (reference KeyFrame merge edges,
        # include/KeyFrame.h:86-101): later essential graphs keep the two
        # sessions pinned together through this pair
        system.map = mapstate.add_loop_edge(system.map, system.last_kf_idx, cand,
                                            res.R12, res.t12, res.s12)
        # the tracker: the welded keyframe's pose in the merged map
        ki = system.last_kf_idx
        R_cur, t_cur = _row(system.map.kf_R, ki), _row(system.map.kf_t, ki)
        system._set_pose(R_cur, t_cur)
        system.R_prev, system.t_prev = R_cur, t_cur
        system.has_velocity = False
        if hasattr(system, "frame_prior"):   # inertial tracker state
            system.frame_prior = None
            system._map_updated = True
            # the velocity was carried with the map (transform_map); biases
            # do not depend on the frame
            system.vel = _row(system.map.kf_vel, ki)
            system.last_body = system._cam_to_body(R_cur, t_cur)
        # one read: the world Sim3 for the trajectory, the merged keyframes'
        # validity for the database
        host = torch.cat([Rw.reshape(-1), tw, sw.reshape(1),
                          system.map.kf_valid[:nk].to(torch.float32)]).cpu().numpy()
        Rw_np, tw_np, sw_np = host[:9].reshape(3, 3), host[9:12], float(host[12])
        # trajectories: the archived one first, then the current one carried
        cur_traj = [(ts_, Rw_np @ Rwc_, sw_np * (Rw_np @ twc_) + tw_np)
                    for ts_, Rwc_, twc_ in system.trajectory]
        system.trajectory = list(sess.trajectory) + cur_traj
        # the place-recognition database over the merged keyframes
        lc.db = kdb.clear(lc.db)
        for k in np.nonzero(host[13:])[0].tolist():
            lc.add_keyframe(system.map, k, fb.frame_view(system.bank, k))
        system.atlas.sessions.pop(si)
        system.last_merge = dict(session=si, kf=kf_idx, cand=cand, n_matches=n_matches,
                                 n_inliers=n_inl, kf_off=kf_off, pt_off=pt_off,
                                 R=Rw_np, t=tw_np, s=sw_np)
        return True
    return False
