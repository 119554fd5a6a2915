"""Monocular-inertial SLAM system.

Counterpart of `orbslam3_tpu/pipeline/inertial_system.py` (parity targets):
  * the IMU queue and the two preintegrations, since the last keyframe and
    since the last frame, with the reference's boundary handling
    (Tracking::GrabImuData / PreintegrateIMU, src/Tracking.cc:176-290);
  * the pose prediction from the IMU once it is initialized
    (Tracking::PredictStateIMU, src/Tracking.cc:293-350), local-map
    tracking from it and the visual-inertial pose optimization against the
    last keyframe or the last frame (src/Tracking.cc:934-956);
  * the staged IMU initialization (LocalMapping::InitializeIMU,
    src/LocalMapping.cc:1080): the inertial-only optimizer after
    `init_time_s` of keyframes, scale < 0.1 rejected, every pose, point
    and velocity re-anchored with the recovered Sim3 (gravity, scale)
    (Map::UpdateKFsAndMapCoordianteFrames, src/Map.cc:253), the raw
    buffers reintegrated at the new bias, then a visual-inertial full BA
    (FullInertialBA); the VIBA1 and VIBA2 stages repeat it later;
  * after the initialization keyframe velocities and biases live in the map
    and the window BA of the keyframe step is the visual-inertial one over
    a temporal window (LocalInertialBA);
  * keyframe culling merges the two factors that meet at the culled
    keyframe by replaying their raw buffers (MergePrevious,
    src/ImuTypes.cc:239).

The camera pose Tcw is the map's; Tbc (body <- camera) is the fixed
extrinsic, and the IMU terms use the body pose Twb = (Tbc Tcw)^-1.

The JAX package fuses the inertial tracked frame into one jitted program and
reads one stats array back.  Here the same steps run eagerly on the device
and read back twice: the first tracking attempt's inlier count, which
decides the weak-match retry at twice the radius (the JAX program's
`lax.cond`), and the packed stats with the final pose.  The branch between
LastKeyFrame and LastFrame is the host's decision in both.  The IMU rows of a
frame go up in one upload from pinned memory that does not wait for the
device.  The preintegration loops over the valid rows only; the JAX
package's padding to fixed capacities (64 / 512 rows, power-of-two factor
stacks) exists for its jit shapes and changes no result.

After a loop closure on an IMU-initialized map the pending GBA is the full
inertial BA over every factor (`_schedule_gba`), and its merge carries the
velocity and drops the frame prior.  The keyframe step stays synchronous
(`_async_ok` is False, as in JAX: the LastKeyFrame factor reads the
keyframe's post-BA velocity and bias), and the inertial tracked frame does
not poll the pending chain: a keyframe, a loss, an archive or shutdown
merges it, as in JAX.  A map merge welds rigidly once the IMU is
initialized, and its welding BA is then the visual-inertial window BA
(`_window_ba`), as JAX's rebinding of `_local_ba` makes it.
"""

from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import imu as imu_ops
from ..slam_map.state import _row, _set_at, _set_drop, _upload
from ..solver import inertial as inertial_solver
from ..solver import vi_ba as vi_ba_solver
from ..solver import vi_pose_opt as vpo
from . import mapping, system as base, tracking


def reference_imu_steps(take, t0: float, t1: float, nxt=None):
    """Integration-step schedule of reference Tracking::PreintegrateIMU
    (src/Tracking.cc:243-283): midpoint-rule measurement values with linear
    interpolation at the interval endpoints.

    `take`: samples (t, gyro, acc) with t0 < t <= t1, time-sorted.  `nxt`:
    the first sample beyond t1 if there is one (peeked, not consumed; it
    interpolates the last step, which otherwise extrapolates linearly).

    Returns (acc (n,3), gyr (n,3), dts (n,)) numpy float32, or None when
    there are no samples.  sum(dts) == t1 - t0.
    """
    pts = list(take) + ([nxt] if nxt is not None else [])
    n = len(pts) - 1
    if n < 0:
        return None
    if n == 0:
        # one sample covers the whole interval (reference i == 0 == n-1)
        t, g, a = pts[0]
        return (np.asarray([a], np.float32).reshape(1, 3),
                np.asarray([g], np.float32).reshape(1, 3),
                np.asarray([max(t1 - t0, 0.0)], np.float32))
    acc = np.zeros((n, 3), np.float32)
    gyr = np.zeros((n, 3), np.float32)
    dts = np.zeros(n, np.float32)
    for i in range(n):
        ti, gi, ai = pts[i]
        tj, gj, aj = pts[i + 1]
        tab = max(tj - ti, 1e-9)
        if i == 0 and i < n - 1:
            w = (ti - t0) / tab
            a = 0.5 * (ai + aj - (aj - ai) * w)
            g = 0.5 * (gi + gj - (gj - gi) * w)
            dt = tj - t0
        elif i < n - 1:
            a = 0.5 * (ai + aj)
            g = 0.5 * (gi + gj)
            dt = tab
        elif i > 0:
            w = (tj - t1) / tab
            a = 0.5 * (ai + aj - (aj - ai) * w)
            g = 0.5 * (gi + gj - (gj - gi) * w)
            dt = t1 - ti
        else:   # i == 0 == n-1: two samples
            a, g = ai, gi
            dt = t1 - t0
        acc[i] = a
        gyr[i] = g
        dts[i] = max(dt, 0.0)
    return acc, gyr, dts


def pack_imu_rows(steps, cap: int) -> np.ndarray:
    """Integration steps (acc (n,3), gyr (n,3), dts (n,)) as packed rows
    [acc(3) gyr(3) dt ok], truncated or padded to `cap` rows, the valid
    rows first."""
    acc, gyr, dts = steps
    n = min(acc.shape[0], cap)
    packed = np.zeros((cap, 8), np.float32)
    packed[:n, 0:3], packed[:n, 3:6], packed[:n, 6] = acc[:n], gyr[:n], dts[:n]
    packed[:n, 7] = 1.0
    return packed


def _n_rows(packed: np.ndarray) -> int:
    """The number of valid rows of `pack_imu_rows`'s layout."""
    return int(np.count_nonzero(packed[:, 7] > 0.5))


@dataclasses.dataclass(frozen=True)
class InertialConfig:
    """The JAX package's `InertialConfig` with the same defaults, less
    `max_factors`: the cap on a stacked factor list pads the JAX jit shapes
    and never binds (a map of n_kf keyframes has fewer factors)."""
    imu_freq: float = 200.0
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3e-3
    Tbc: tuple = ()              # 4x4 row-major; empty = identity
    init_time_s: float = 2.0     # keyframe time before the inertial init
    init_min_kfs: int = 6
    refine_time_s: float = 5.0   # second stage (VIBA1)
    refine2_time_s: float = 15.0  # third stage (VIBA2, LocalMapping.cc:242)
    max_imu_per_frame: int = 64  # rows of one frame interval
    # rows since the last keyframe: max_imu_per_frame * preint_buf_factor
    preint_buf_factor: int = 8
    vi_window_factors: int = 12  # factors in the VI window BA
    vi_ba_iters: int = 8
    # FullInertialBA after the inertial-only init and VIBA1 (reference
    # bFIBA, src/LocalMapping.cc:1201-1210) over the newest `fiba_cams` KFs
    fiba: bool = True
    fiba_iters: int = 12
    fiba_cams: int = 64
    # per-frame visual-inertial pose optimization in the tracker
    use_vi_pose_opt: bool = True
    # bad-IMU failsafe (reference src/LocalMapping.cc:122-126 and
    # src/Tracking.cc:368-373): reset the map if VIBA1 has not converged
    # within this much keyframe time
    reset_time_thresh: float = 500.0


class VITrackOut(NamedTuple):
    """Device outputs of the inertial tracked frame."""
    R_tr: torch.Tensor      # track-result camera pose (before the VI refinement)
    t_tr: torch.Tensor
    kp_pt: torch.Tensor     # keypoint -> map point bindings
    R_cur: torch.Tensor     # final camera pose (VI-refined when accepted)
    t_cur: torch.Tensor
    Rwb: torch.Tensor       # final body state
    pwb: torch.Tensor
    vel: torch.Tensor
    prior: Optional[vpo.VIPosePrior]   # the next frame's ConstraintPoseImu
    Rg: torch.Tensor        # IMU-predicted camera pose (loss path)
    tg: torch.Tensor
    R_pred: torch.Tensor    # IMU-predicted body state (loss path)
    p_pred: torch.Tensor
    v_pred: torch.Tensor
    stats: torch.Tensor     # int32 [n_inl, vi_ok, n_vi_inl, n_inl_try1]


class InertialSystem(base.System):
    # the stereo-inertial System sets True: the scale is metric already and
    # the init solves gravity, bias and velocities only
    imu_fix_scale = False

    def __init__(self, config: base.SlamConfig, icfg: InertialConfig, device=None,
                 seed: int = 42):
        super().__init__(config, device=device, seed=seed)
        self.icfg = icfg
        # the VI chain couples tracking to the keyframe's optimization (the
        # LastKeyFrame factor reads post-BA velocities and biases), so the
        # keyframe step stays synchronous
        self._async_ok = False
        dev = self.device
        Tbc = np.asarray(icfg.Tbc, np.float64).reshape(4, 4) if icfg.Tbc else np.eye(4)
        on = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
        # Tbc: body <- camera (x_b = Rbc x_c + tbc); Tcb is its inverse
        self.Rbc = on(Tbc[:3, :3])
        self.tbc_vec = on(Tbc[:3, 3])
        self.Rcb = self.Rbc.T
        self.tcb = -self.Rbc.T @ self.tbc_vec
        self.calib = imu_ops.ImuCalib.create(
            icfg.noise_gyro, icfg.noise_acc, icfg.walk_gyro, icfg.walk_acc, icfg.imu_freq,
            Tbc_R=Tbc[:3, :3], Tbc_t=Tbc[:3, 3], device=dev)
        self.gravity = imu_ops.gravity(dev)
        self._inv_s2_table = 1.0 / mapping._scale_factors(
            config.orb.scale_factor, config.orb.n_levels, dev) ** 2
        # IMU state
        self.imu_queue: list = []        # (t, gyro, acc) not yet integrated
        self.kf_imu_buffer: list = []    # samples since the last keyframe
        self.last_frame_ts: Optional[float] = None
        self.imu_initialized = False
        self.viba1_done = False
        self.viba2_done = False
        self.bias = torch.zeros(6, device=dev)
        self.vel = torch.zeros(3, device=dev)   # body velocity, world frame
        self.last_body = None            # (Rwb, pwb) of the previous frame
        self.preints: list = []          # per keyframe interval
        self.preint_kf_pairs: list = []
        # raw (acc, gyr, dts) numpy per factor, for Reintegrate on a bias
        # change and MergePrevious on culling (reference src/ImuTypes.cc:170,239)
        self.preint_raw: list = []
        self.kf_time0 = None
        self.frame_prior: Optional[vpo.VIPosePrior] = None   # ConstraintPoseImu
        self._frame_rows = None          # packed IMU rows of the current frame
        self._map_updated = True
        # what the last inertial tracked frame did: "lastkf" / "lastframe" and
        # its stats [n_inl, vi_ok, n_vi_inl, n_inl_try1]
        self.last_vi_branch: Optional[str] = None
        self.last_vi_stats: Optional[np.ndarray] = None
        self.last_imu_stage_frame = -1   # the frame that last ran an IMU stage

    # ------------------------------------------------------------------ api
    def grab_imu(self, ts: float, gyro, acc):
        self.imu_queue.append((ts, np.asarray(gyro, np.float32), np.asarray(acc, np.float32)))

    def track_monocular(self, img, ts: float, features=None):
        self._frame_rows = self._interval_rows(self.last_frame_ts, ts)
        self.last_frame_ts = ts
        return super().track_monocular(img, ts, features)

    # ------------------------------------------------------- preintegration
    def _preint_rows(self, rows: torch.Tensor, n: int, bias) -> imu_ops.Preintegrated:
        """Preintegrate the first n packed rows [acc gyr dt ok] at `bias`."""
        return imu_ops.preintegrate(rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7] > 0.5,
                                    self.calib, bias, n_valid=n)

    def _interval_rows(self, t0: Optional[float], t1: float):
        """Packed rows (max_imu_per_frame, 8) of the queued samples in
        (t0, t1] with the reference's midpoint and endpoint-interpolation
        scheme (the sample just beyond t1 is peeked and stays queued), or
        None."""
        if t0 is None:
            # no preintegration for the first frame: drop stale samples
            self.imu_queue = [s for s in self.imu_queue if s[0] > t1 - 1e-9]
            return None
        take = [s for s in self.imu_queue if s[0] <= t1]
        nxt = self.imu_queue[len(take)] if len(self.imu_queue) > len(take) else None
        self.imu_queue = self.imu_queue[len(take):]
        self.kf_imu_buffer.extend(take)
        if not take:
            return None
        return pack_imu_rows(reference_imu_steps(take, t0, t1, nxt), self.icfg.max_imu_per_frame)

    def _since_kf_rows(self, ts_now: float):
        """Packed rows covering (last keyframe ts, now] from the buffered
        samples (reference mpImuPreintegratedFromLastKF), or None."""
        kf_ts = self.last_kf_ts
        take = [s for s in self.kf_imu_buffer if kf_ts < s[0] <= ts_now]
        if len(take) < 2:
            return None
        nxt = next((s for s in self.kf_imu_buffer if s[0] > ts_now), None)
        return pack_imu_rows(reference_imu_steps(take, kf_ts, ts_now, nxt),
                             self.icfg.max_imu_per_frame * self.icfg.preint_buf_factor)

    def _preintegrate_buffer(self, t0: float, t1: float):
        """(Preintegrated, raw (acc, gyr, dts) numpy) of the buffered samples
        in (t0, t1], or None with fewer than 3."""
        take = [s for s in self.kf_imu_buffer if t0 < s[0] <= t1]
        self.kf_imu_buffer = [s for s in self.kf_imu_buffer if s[0] > t1]
        if len(take) < 3:
            return None
        nxt = self.kf_imu_buffer[0] if self.kf_imu_buffer else None
        acc, gyr, dts = reference_imu_steps(take, t0, t1, nxt)
        return self._preint_raw(acc, gyr, dts, self.bias), (acc, gyr, dts)

    def _preint_raw(self, acc: np.ndarray, gyr: np.ndarray, dts: np.ndarray, bias):
        """Preintegrate a raw sample buffer of any length."""
        rows = pack_imu_rows((acc, gyr, dts), len(acc))
        return self._preint_rows(_upload(rows, self.device), len(acc), bias)

    # -------------------------------------------------------------- poses
    def _body_to_cam(self, Rwb, pwb):
        """Twb -> Tcw: Tcw = Tcb Tbw."""
        Rbw = Rwb.T
        return self.Rcb @ Rbw, self.Rcb @ (-Rbw @ pwb) + self.tcb

    def _cam_to_body(self, Rcw, tcw):
        """Tcw -> Twb: Tbw = Tbc Tcw, Twb = Tbw^-1."""
        Rwb = (self.Rbc @ Rcw).T
        return Rwb, -Rwb @ (self.Rbc @ tcw + self.tbc_vec)

    def _kf_body_poses(self, m):
        """Body poses (Rwb (K,3,3), pwb (K,3)) of every keyframe slot."""
        Rbw = torch.einsum("ij,kjl->kil", self.Rbc, m.kf_R)
        tbw = torch.einsum("ij,kj->ki", self.Rbc, m.kf_t) + self.tbc_vec
        Rwb = Rbw.transpose(1, 2)
        return Rwb, -torch.einsum("kij,kj->ki", Rwb, tbw)

    # -------------------------------------------------------------- tracking
    def _vi_track_step(self, ff, rows, nF: int, nK: int, use_lastkf: bool, has_opt: bool,
                       radius: float, prior, Rwb, pwb, vel, bias):
        """The inertial tracked frame: the frame's preintegration, the IMU
        prediction, local-map tracking (with the weak-match retry at twice
        the radius), the visual-inertial pose optimization against the last
        keyframe (`use_lastkf`, a factor from the `nK` rows since it) or
        against the last frame under `prior`, and the accept select.
        `rows`: the frame's nF packed rows, then the nK since the last
        keyframe.  Returns (map, VITrackOut); reads back the first attempt's
        inlier count."""
        cfg = self.cfg
        m, view = self.map, self.view
        preF = self._preint_rows(rows[:nF], nF, bias)
        R2, p2, v2 = imu_ops.predict_state(Rwb, pwb, vel, bias, preF, self.gravity)
        Rg, tg = self._body_to_cam(R2, p2)

        def run_track(m_, rad):
            tr = tracking.track_local_map(
                m_, ff, Rg, tg, cfg.cam_model, self.cam_params, cfg.image_hw,
                cfg.orb.scale_factor, cfg.orb.n_levels, radius_th=rad, view=view)
            return tr, tracking.update_point_stats(m_, tr)

        tr1, m1 = run_track(m, radius)
        tr, m_out = tr1, m1
        if int(tr1.n_inliers) < cfg.min_track_inliers:
            # weak match: one retry at twice the radius (the reference
            # doubles th and searches again under 20 matches); the first
            # attempt's point stats stay, as in the JAX program
            tr2, m2 = run_track(m1, 2.0 * radius)
            better = tr2.n_inliers > tr1.n_inliers
            tr = tracking.TrackResult(*(torch.where(better, a, b) for a, b in zip(tr2, tr1)))
            m_out = type(m1)(*(torch.where(better, a, b) for a, b in zip(m2, m1)))

        P = m.pt_xyz.shape[0]
        X = m_out.pt_xyz[torch.clamp(tr.kp_pt, 0, P - 1).long()]
        inv_s2 = self._inv_s2_table[mapping._lv(ff.octave, cfg.orb.n_levels)]
        valid = (tr.kp_pt >= 0) & ff.valid
        Rwb_t, pwb_t = self._cam_to_body(tr.R, tr.t)
        n_vi = torch.zeros((), dtype=torch.int32, device=self.device)
        Rwb_f, pwb_f, vel_f, prior_o = Rwb_t, pwb_t, v2, prior
        ok = torch.zeros((), dtype=torch.bool, device=self.device)
        if has_opt:
            vis = (X, ff.xy, inv_s2, valid, cfg.cam_model, self.cam_params, self.Rcb,
                   self.tcb, self.gravity)
            if use_lastkf:
                # PoseInertialOptimizationLastKeyFrame (src/Optimizer.cc:3447):
                # the factor since the last keyframe
                preK = self._preint_rows(rows[nF:nF + nK], nK, bias)
                ki = max(self.last_kf_idx, 0)
                Rwb_kf, pwb_kf = self._cam_to_body(_row(m_out.kf_R, ki), _row(m_out.kf_t, ki))
                res = vpo.vi_pose_optimization(
                    Rwb_t, pwb_t, v2, bias, Rwb_kf, pwb_kf, _row(m_out.kf_vel, ki),
                    _row(m_out.kf_bias, ki), inertial_solver.factor_from_preint(preK), *vis)
                prior_o = vpo.VIPosePrior(Rwb=res.Rwb, pwb=res.pwb, vel=res.vel, bias=bias,
                                          H=res.H)
            else:
                # PoseInertialOptimizationLastFrame (src/Optimizer.cc:3846):
                # the frame interval's factor and the carried prior
                res, prior_o = vpo.vi_pose_optimization_last_frame(
                    Rwb_t, pwb_t, v2, bias, prior, inertial_solver.factor_from_preint(preF),
                    *vis)
            n_vi = res.n_inliers
            ok = n_vi >= 8
            Rwb_f = torch.where(ok, res.Rwb, Rwb_t)
            pwb_f = torch.where(ok, res.pwb, pwb_t)
            vel_f = torch.where(ok, res.vel, v2)
        R_cur, t_cur = self._body_to_cam(Rwb_f, pwb_f)
        stats = torch.stack([tr.n_inliers.to(torch.int32), ok.to(torch.int32),
                             n_vi.to(torch.int32), tr1.n_inliers.to(torch.int32)])
        return m_out, VITrackOut(
            R_tr=tr.R, t_tr=tr.t, kp_pt=tr.kp_pt, R_cur=R_cur, t_cur=t_cur,
            Rwb=Rwb_f, pwb=pwb_f, vel=vel_f, prior=prior_o, Rg=Rg, tg=tg,
            R_pred=R2, p_pred=p2, v_pred=v2, stats=stats)

    def _track_frame(self, ff, ts):
        if not (self.imu_initialized and self.last_body is not None and
                self._frame_rows is not None):
            super()._track_frame(ff, ts)
            if self.state == base.OK:
                self.last_body = self._cam_to_body(self.R_cur, self.t_cur)
            return
        # LastKeyFrame right after a map update (keyframe, BA, re-anchor),
        # else the frame-to-frame LastFrame chain under the marginalized
        # prior (reference TrackLocalMap dispatch, src/Tracking.cc:934-956)
        use_lastkf = self._map_updated or self.frame_prior is None
        has_opt = self.icfg.use_vi_pose_opt
        rowsF = self._frame_rows
        parts = [rowsF[:_n_rows(rowsF)]]
        nK = 0
        if use_lastkf and has_opt:
            rowsK = self._since_kf_rows(ts)
            if rowsK is None:
                has_opt = False
            else:
                nK = _n_rows(rowsK)
                parts.append(rowsK[:nK])
        # search radius: tight under a warm IMU prediction, wide right after
        # a map update (a correction moves points while the predicted pose
        # stays good)
        radius = 12.0 if self._map_updated else 4.0
        Rwb, pwb = self.last_body
        m2, out = self._vi_track_step(
            ff, _upload(np.concatenate(parts), self.device), len(parts[0]), nK, use_lastkf,
            has_opt,
            radius, self.frame_prior, Rwb, pwb, self.vel, self.bias)
        # the frame's read: stats with the final pose
        host = torch.cat([out.stats.to(torch.float32), out.R_cur.reshape(-1),
                          out.t_cur]).cpu().numpy()
        st = host[:4].astype(np.int64)
        n_inl, vi_ok = int(st[0]), bool(st[1])
        self.last_vi_branch = "lastkf" if use_lastkf else "lastframe"
        self.last_vi_stats = st
        self.last_track_inliers = n_inl
        if n_inl < max(8, self.cfg.min_track_inliers // 3):
            # RECENTLY_LOST, predicting from the IMU (reference
            # Tracking.cc:467-471); reset only when patience runs out
            self._set_pose(out.Rg, out.tg)
            self.R_prev, self.t_prev = out.Rg, out.tg
            self.vel = out.v_pred
            self.last_body = (out.R_pred, out.p_pred)
            if self._handle_tracking_loss(ff):
                return
            self._reset()
            return
        self.map = m2
        self.lost_frames = 0
        self.state = base.OK
        self.R_prev, self.t_prev = self.R_cur, self.t_cur
        self._set_pose(out.R_cur, out.t_cur, host=(host[4:13].reshape(3, 3), host[13:16]))
        self.has_velocity = True
        self.last_kp_pt = out.kp_pt   # the viewer's FrameDrawer overlay
        self.vel = out.vel
        self.last_body = (out.Rwb, out.pwb)
        if vi_ok:
            self.frame_prior = out.prior
            if use_lastkf:
                self._map_updated = False
        elif not use_lastkf:
            # the LastFrame chain was rejected: drop the prior (the
            # reference deletes mpcpi when the optimization fails)
            self.frame_prior = None
        need_kf = (self.frame_id - self.last_kf_id >= self.cfg.max_frames_between_kf) or \
            (n_inl < self.cfg.kf_inlier_ratio * max(self.inliers_at_last_kf, 1))
        if need_kf and not self.localization_only and \
                self.n_kf_host < self.cfg.map_capacity.n_kf - 1:
            tr = types.SimpleNamespace(kp_pt=out.kp_pt, R=out.R_tr, t=out.t_tr)
            self._insert_keyframe(ff, tr, ts, n_inl)

    # -------------------------------------------------------------- keyframe
    def _insert_keyframe(self, ff, tr, ts, n_inl):
        prev_idx = self.last_kf_idx
        # the keyframe interval's preintegration from the buffered samples
        st = self._preintegrate_buffer(self.last_kf_ts, ts)
        # once the IMU is initialized the keyframe step runs the VI window
        # BA (`_window_ba`; LocalInertialBA replaces LocalBundleAdjustment,
        # src/LocalMapping.cc:117-152)
        super()._insert_keyframe(ff, tr, ts, n_inl)
        new_idx = self.last_kf_idx
        if st is not None:
            pre, raw = st
            self.preints.append(pre)
            self.preint_kf_pairs.append((prev_idx, new_idx))
            self.preint_raw.append(raw)
        self._map_updated = True
        # the tracker's velocity and bias at the new keyframe
        self.map = self.map._replace(kf_vel=_set_at(self.map.kf_vel, new_idx, self.vel),
                                     kf_bias=_set_at(self.map.kf_bias, new_idx, self.bias))
        if self.kf_time0 is None:
            self.kf_time0 = ts
        icfg = self.icfg
        if not self.imu_initialized and len(self.preints) >= icfg.init_min_kfs and \
                ts - self.kf_time0 >= icfg.init_time_s:
            self._initialize_imu(prior_g=1e2, prior_a=1e6)
        elif self.imu_initialized and not self.viba1_done and \
                ts - self.kf_time0 >= icfg.refine_time_s:
            # VIBA1 (reference InitializeIMU at ~5 s with weaker priors,
            # src/LocalMapping.cc:221-223)
            self.viba1_done = self._initialize_imu(prior_g=1.0, prior_a=1e5)
        elif self.viba1_done and not self.viba2_done and \
                ts - self.kf_time0 >= icfg.refine2_time_s:
            # VIBA2 (reference src/LocalMapping.cc:242-244)
            self.viba2_done = self._initialize_imu(prior_g=0.0, prior_a=0.0)
        # bad-IMU failsafe: the init stages never converged
        if not self.viba1_done and self.kf_time0 is not None and \
                ts - self.kf_time0 > icfg.reset_time_thresh:
            self._reset()
            return
        # the init stages re-anchor and re-optimize the whole map
        self._refresh_view()

    def _window_ba(self):
        return self._vi_ba_dispatch if self.imu_initialized else None

    def _factor_stack(self, pairs, preints) -> inertial_solver.PreintFactor:
        return inertial_solver.stack_preints_device(
            preints, [p[0] for p in pairs], [p[1] for p in pairs])

    def _window_factors(self):
        """The factors touching the BA window: the newest vi_window_factors."""
        capf = self.icfg.vi_window_factors
        if not self.preints:
            return None
        return self._factor_stack(self.preint_kf_pairs[-capf:], self.preints[-capf:])

    def _vi_ba_dispatch(self, m, center_kf, bank):
        f = self._window_factors()
        if f is None:
            return base.local_ba(self.cfg, self.cam_params, m, center_kf)
        cams, pts, obs = self.cfg.ba_caps
        return self._vi_ba(m, center_kf, f, bank, self.cfg.local_ba_window, cams, pts, obs,
                           self.icfg.vi_ba_iters, pcg=32)

    def _vi_ba(self, m, center_kf, f, bank, window: int, cams: int, pts: int, obs: int,
               iters: int, pcg: int = 16, schur: str = "dense"):
        """The visual-inertial BA over the temporal window ending at
        `center_kf`: LocalInertialBA at window = local_ba_window
        (src/Optimizer.cc:2448), FullInertialBA at the map capacity
        (src/Optimizer.cc:371-762).  Returns the map with the free
        keyframes' poses, velocities and biases and the points written
        back."""
        cfg = self.cfg
        prob_v, cam_sel, cam_ok, pt_sel, pt_ok = mapping.gather_window_problem_bank(
            m, bank, center_kf, window, cfg.orb.n_levels, cfg.orb.scale_factor,
            cap_cams=cams, cap_pts=pts, cap_obs=obs, window_mode="temporal", min_anchors=1)
        K = m.kf_R.shape[0]
        dev = self.device
        C = cam_sel.shape[0]
        cam_inv = _set_drop(torch.full((K,), -1, dtype=torch.int32, device=dev),
                            torch.where(cam_ok, cam_sel, K),
                            torch.arange(C, dtype=torch.int32, device=dev))
        # the factors in the compacted camera indexing
        fi = cam_inv[torch.clamp(f.kf_i, 0, K - 1).long()]
        fj = cam_inv[torch.clamp(f.kf_j, 0, K - 1).long()]
        f2 = f._replace(kf_i=torch.clamp_min(fi, 0), kf_j=torch.clamp_min(fj, 0),
                        valid=f.valid & (fi >= 0) & (fj >= 0))
        Rbw = torch.einsum("ij,kjl->kil", self.Rbc, prob_v.R)
        tbw = torch.einsum("ij,kj->ki", self.Rbc, prob_v.t) + self.tbc_vec
        Rwb = Rbw.transpose(1, 2)
        prob = vi_ba_solver.VIProblem(
            Rwb=Rwb, pwb=-torch.einsum("kij,kj->ki", Rwb, tbw),
            vel=m.kf_vel[cam_sel], bias=m.kf_bias[cam_sel],
            cam_fixed=prob_v.cam_fixed, cam_valid=prob_v.cam_valid,
            X=prob_v.X, pt_valid=prob_v.pt_valid, obs_cam=prob_v.obs_cam,
            obs_pt=prob_v.obs_pt, obs_uv=prob_v.obs_uv,
            obs_inv_sigma2=prob_v.obs_inv_sigma2, obs_valid=prob_v.obs_valid,
            factors=f2, gravity=self.gravity, Rcb=self.Rcb, tcb=self.tcb)
        res = vi_ba_solver.vi_bundle_adjust(prob, cfg.cam_model, self.cam_params,
                                            iterations=iters, lam0=1.0, pcg_iters=pcg,
                                            schur=schur)
        # optimized body poses back to camera poses, scattered back
        Rbw2 = res.Rwb.transpose(1, 2)
        Rcw2 = torch.einsum("ij,kjl->kil", self.Rcb, Rbw2)
        tcw2 = torch.einsum("ij,kj->ki", self.Rcb, -torch.einsum("kij,kj->ki", Rbw2, res.pwb)) \
            + self.tcb
        dstc = torch.where(cam_ok & ~prob_v.cam_fixed, cam_sel, K)
        dstp = torch.where(pt_ok, pt_sel, m.pt_xyz.shape[0])
        return m._replace(kf_R=_set_drop(m.kf_R, dstc, Rcw2), kf_t=_set_drop(m.kf_t, dstc, tcw2),
                          kf_vel=_set_drop(m.kf_vel, dstc, res.vel),
                          kf_bias=_set_drop(m.kf_bias, dstc, res.bias),
                          pt_xyz=_set_drop(m.pt_xyz, dstp, res.X))

    def _full_ba(self, center_kf: int, f):
        """FullInertialBA over the newest fiba_cams keyframes."""
        cams, pts, obs = self.cfg.ba_caps
        return self._vi_ba(self.map, center_kf, f, self.bank, self.cfg.map_capacity.n_kf,
                           self.icfg.fiba_cams, pts, obs, self.icfg.fiba_iters, pcg=48)

    def _schedule_gba(self, ki: int) -> None:
        """On an IMU-initialized map the post-loop GBA is the full inertial
        BA (reference LoopClosing::RunGlobalBundleAdjustment runs
        Optimizer::FullInertialBA there): a visual GBA leaves the monocular
        scale gauge free and could rescale the metric map."""
        if not self.imu_initialized or not self.preints:
            return super()._schedule_gba(ki)
        if not self.cfg.post_loop_gba:
            return
        f = self._factor_stack(self.preint_kf_pairs, self.preints)
        cams, pts, obs = self.cfg.ba_caps
        self._post_chain(
            lambda m, bank, f_: self._vi_ba(m, ki, f_, bank, self.cfg.map_capacity.n_kf,
                                            self.icfg.fiba_cams, pts, obs,
                                            self.icfg.fiba_iters, pcg=48),
            ki, "gba", (self.map, self.bank, f))

    # -------------------------------------------------------------- IMU init
    def _initialize_imu(self, prior_g: float = 1e2, prior_a: float = 1e6) -> bool:
        """Gravity, scale and bias initialization and the map's re-anchoring.
        Returns True when the stage converged (scale accepted).  prior_g /
        prior_a follow the reference's schedule (src/LocalMapping.cc:195,
        221, 242: init 1e2/1e6, VIBA1 1/1e5, VIBA2 0/0)."""
        self.last_imu_stage_frame = self.frame_id
        m = self.map
        K = m.kf_R.shape[0]
        dev = self.device
        # the keyframes that the factors name; the others have no residual
        used = sorted({k for p in self.preint_kf_pairs for k in p})
        local = {k: n for n, k in enumerate(used)}
        f = self._factor_stack([(local[i], local[j]) for i, j in self.preint_kf_pairs],
                               self.preints)
        sel = _upload(np.asarray(used, np.int64), dev)
        Rwb, pwb = self._kf_body_poses(m)
        res = inertial_solver.inertial_only_init(
            f, Rwb[sel], pwb[sel], m.kf_valid[sel], prior_g=prior_g, prior_a=prior_a,
            iterations=60, fix_scale=self.imu_fix_scale)
        s = 1.0 if self.imu_fix_scale else float(res.scale)
        if s < 0.1:   # reference rejects scale < 0.1 (LocalMapping.cc:1166)
            return False
        # re-anchor: x' = s Rgw x with Rgw = Rwg^T
        Rgw = res.Rwg.T
        self._apply_world_sim3(Rgw, s)
        # the init's velocities are metric already: rotate them only
        vel = torch.zeros((K, 3), dtype=torch.float32, device=dev).index_copy(0, sel, res.vel)
        vel_new = vel @ Rgw.T
        self.map = self.map._replace(kf_vel=vel_new,
                                     kf_bias=res.bias[None, :].expand(K, 6).clone())
        self.bias = res.bias
        self.vel = vel_new[self.last_kf_idx]
        # reintegrate every factor at the new bias from its raw buffer
        # (reference Preintegrated::Reintegrate, src/ImuTypes.cc:170)
        self.preints = [self._preint_raw(a, g, d, self.bias) for (a, g, d) in self.preint_raw]
        self.imu_initialized = True
        # FullInertialBA (bFIBA, src/LocalMapping.cc:1201-1210)
        if self.icfg.fiba and self.preints:
            self.map = self._full_ba(self.last_kf_idx,
                                     self._factor_stack(self.preint_kf_pairs, self.preints))
            self.bias = self.map.kf_bias[self.last_kf_idx]
            self.vel = self.map.kf_vel[self.last_kf_idx]
        # the tracker follows the re-anchored keyframe
        self._set_pose(self.map.kf_R[self.last_kf_idx], self.map.kf_t[self.last_kf_idx])
        self.R_prev, self.t_prev = self.R_cur, self.t_cur
        self.last_body = self._cam_to_body(self.R_cur, self.t_cur)
        self.has_velocity = False
        self.frame_prior = None
        self._map_updated = True
        return True

    def _cull_keyframe(self, kf_idx: int) -> None:
        """Keep the preintegration chain whole across a culled keyframe: the
        two factors meeting there become one spanning factor, replayed from
        their raw buffers (reference Preintegrated::MergePrevious,
        src/ImuTypes.cc:239); a factor at an end of the chain is dropped."""
        pairs = self.preint_kf_pairs
        a = next((i for i, p in enumerate(pairs) if p[1] == kf_idx), None)
        b = next((i for i, p in enumerate(pairs) if p[0] == kf_idx), None)
        if a is not None and b is not None:
            raw = tuple(np.concatenate([self.preint_raw[a][c], self.preint_raw[b][c]])
                        for c in range(3))
            merged = self._preint_raw(*raw, self.bias)
            pair = (pairs[a][0], pairs[b][1])
            for i in sorted((a, b), reverse=True):
                del self.preints[i], self.preint_kf_pairs[i], self.preint_raw[i]
            self.preints.append(merged)
            self.preint_kf_pairs.append(pair)
            self.preint_raw.append(raw)
            # temporally ordered: the window takes the newest at the tail
            order = sorted(range(len(self.preint_kf_pairs)),
                           key=lambda i: self.preint_kf_pairs[i][1])
            self.preints = [self.preints[i] for i in order]
            self.preint_kf_pairs = [self.preint_kf_pairs[i] for i in order]
            self.preint_raw = [self.preint_raw[i] for i in order]
        elif a is not None or b is not None:
            i = a if a is not None else b
            del self.preints[i], self.preint_kf_pairs[i], self.preint_raw[i]

    def _create_map_in_atlas(self):
        """A timestamp regression also clears the IMU queue (reference
        src/Tracking.cc:385-388): queued samples straddle the discontinuity."""
        self.imu_queue = []
        super()._create_map_in_atlas()

    def _archive_and_new_map(self):
        """Archive the map and clear all inertial bookkeeping (reference
        Tracking::ResetActiveMap, src/Tracking.cc:1330-1380)."""
        super()._archive_and_new_map()
        self.imu_initialized = False
        self.viba1_done = False
        self.viba2_done = False
        self.preints = []
        self.preint_kf_pairs = []
        self.preint_raw = []
        self.kf_imu_buffer = []
        self.kf_time0 = None
        self.last_body = None
        self.bias = torch.zeros(6, device=self.device)
        self.vel = torch.zeros(3, device=self.device)
        self.frame_prior = None
        self._map_updated = True

    def _apply_world_sim3(self, Rg, s: float):
        """The world transform x' = s Rg x on every keyframe, point and
        velocity, on the recorded trajectory and on the georeference's
        window of SLAM positions, which is then fitted again (reference
        Map::UpdateKFsAndMapCoordianteFrames; without it the Umeyama fit
        would mix frames from before and after the re-anchoring)."""
        Rg_np = Rg.cpu().numpy()
        if self.georef is not None and self.georef._slam:
            R64 = Rg_np.astype(np.float64)
            self.georef._slam = [(float(s) * (R64 @ np.asarray(p, np.float64))).astype(np.float32)
                                 for p in self.georef._slam]
            self.georef.transform = None
            self.georef.update()
        m = self.map
        self.map = m._replace(
            kf_R=torch.einsum("kij,lj->kil", m.kf_R, Rg), kf_t=m.kf_t * s,
            pt_xyz=s * torch.einsum("ij,kj->ki", Rg, m.pt_xyz),
            kf_vel=s * torch.einsum("ij,kj->ki", Rg, m.kf_vel),
            pt_normal=torch.einsum("ij,kj->ki", Rg, m.pt_normal),
            pt_min_dist=m.pt_min_dist * s, pt_max_dist=m.pt_max_dist * s)
        self.trajectory = [(ts_, Rg_np @ Rwc_, float(s) * (Rg_np @ twc_))
                           for ts_, Rwc_, twc_ in self.trajectory]
