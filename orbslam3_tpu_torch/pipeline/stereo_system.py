"""Stereo SLAM: metric initialization from one pair and depth-based point
creation on top of the monocular pipeline.

Counterpart of `orbslam3_tpu/pipeline/stereo_system.py` (parity targets,
upstream's stereo path):
  * Tracking::StereoInitialization: the first pair with enough stereo
    depths makes the map at once, at metric scale (no two-view RANSAC);
  * CreateNewKeyFrame's stereo points: the keyframe's keypoints with a depth
    that are not bound to a map point become points at once;
  * stereo observations carry (u, v, uR), and the bundle adjusters add the
    third residual row (`SlamConfig.stereo_bf`), which anchors the metric
    scale as the reference's EdgeStereo does.

Two depth sources: a rectified pair (`features.stereo.stereo_match`, then the
subpixel `refine_disparity` when the pixels are given), or a raw fisheye
pair (`StereoConfig.raw_fisheye`: `fisheye_stereo_match` with the rig's
extrinsic; no right-u then, so `stereo_bf` stays 0 and the depth-made points
carry the scale).  Each image goes to the device once, and both its
extraction and the refinement read that copy.  The one host read of a stereo
frame beyond a tracked frame's is the initialization's depth count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..features import stereo as stereo_mod
from ..features.extractor import FeatureFrame
from ..ops import cameras
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _row
from . import system as base


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    baseline: float = 0.11          # EuRoC cam0-cam1 baseline [m]
    min_init_depth_points: int = 100
    max_depth_factor: float = 35.0  # x baseline: the "close point" horizon
    # raw fisheye stereo (reference KannalaBrandt8::TriangulateMatches): no
    # rectification, bearing-space epipolar matching and ray triangulation
    # with the factory extrinsic.  Set cam_model="kb8" and stereo_bf=0
    raw_fisheye: bool = False
    right_cam_params: tuple = ()    # right camera intrinsics (raw mode)
    T_rl: tuple = ()                # 4x4 row-major, right <- left


def stereo_new_points(cfg: base.SlamConfig, m: mapstate.MapState, bank: fb.FeatureBank,
                      ki: int, ff: FeatureFrame, kp_pt, d: stereo_mod.StereoDepth, rays,
                      frame_id: int):
    """Points from the depths of keyframe `ki`'s unbound keypoints (the
    reference's CreateNewKeyFrame stereo points): `rays` are the keypoints'
    camera rays with z = 1.  At a full map `add_points` drops the overflow
    and its keypoints stay unbound.  Returns (map, bank, kp_pt)."""
    sfac, nl = cfg.orb.scale_factor, cfg.orb.n_levels
    free = (kp_pt < 0) & ff.valid & d.valid
    Xc = rays * d.depth[:, None]
    R_ki, t_ki = _row(m.kf_R, ki), _row(m.kf_t, ki)
    X = (Xc - t_ki) @ R_ki
    dist = torch.linalg.norm(Xc, dim=1)
    sf = sfac ** ff.octave.to(torch.float32)
    Ow = -(R_ki.T @ t_ki)
    view = X - Ow
    nrm = view / torch.clamp_min(torch.linalg.norm(view, dim=1, keepdim=True), 1e-9)
    m, pt_idx = mapstate.add_points(m, X, ff.desc, nrm, dist * sf / (sfac ** (nl - 1)),
                                    dist * sf, ki, frame_id, free)
    m = mapstate.add_observations(m, ki, pt_idx, ff.xy, ff.octave, free,
                                  ur=torch.where(d.valid, d.ur, -1.0))
    kp2 = torch.where(free, pt_idx, kp_pt)
    return m, fb.set_binding(bank, ki, kp2), kp2


class StereoSystem(base.System):
    def __init__(self, config: base.SlamConfig, scfg: StereoConfig, device=None,
                 seed: int = 42):
        super().__init__(config, device=device, seed=seed)
        self.scfg = scfg
        self._build_stereo_matchers(config, scfg)

    def _build_stereo_matchers(self, config: base.SlamConfig, scfg: StereoConfig) -> None:
        """The depth association of a pair (`_stereo_match(ff_l, ff_r)`) and
        its refinement (`_refine(img_l, img_r, xy, depth)`), the JAX class's
        `_build_stereo_jits`; shared with the stereo-inertial System, which
        inherits the inertial one."""
        fx = float(config.cam_params[0])
        max_depth = scfg.max_depth_factor * scfg.baseline * 3
        if scfg.raw_fisheye:
            T = np.asarray(scfg.T_rl, np.float64).reshape(4, 4)
            on = lambda x: torch.tensor(np.asarray(x, np.float32), device=self.device)
            R_rl, t_rl, p_r = on(T[:3, :3]), on(T[:3, 3]), on(scfg.right_cam_params)

            def raw_match(fl, fr):
                out = stereo_mod.fisheye_stereo_match(
                    fl, fr, self.cam_params, p_r, R_rl, t_rl, max_depth=max_depth,
                    scale_factor=config.orb.scale_factor, cam_model=config.cam_model)
                # no rectified right-u in raw mode: ur stays -1 (monocular
                # BA rows); the depth-made points carry the metric scale
                return stereo_mod.StereoDepth(
                    ur=torch.full_like(out.depth, -1.0), depth=out.depth, valid=out.valid)

            self._stereo_match = raw_match
            # no row-aligned pair to refine against in raw mode
            self._refine = lambda il, ir, xy, d: d
        else:
            self._stereo_match = lambda fl, fr: stereo_mod.stereo_match(
                fl, fr, fx, scfg.baseline, max_depth=max_depth)
            self._refine = lambda il, ir, xy, d: stereo_mod.refine_disparity(
                il.to(torch.float32), ir.to(torch.float32), xy, d, fx, scfg.baseline)

    # ------------------------------------------------------------------ api
    def _pair_depth(self, img_l, img_r, features_l, features_r) -> FeatureFrame:
        """Extract both images (unless features are given), associate the
        pair into `self._depth`, refine it when both images are given, and
        return the left frame's features."""
        il = None if img_l is None else self._image_on_device(img_l)
        ir = None if img_r is None else self._image_on_device(img_r)
        ff_l = features_l if features_l is not None else self._extract(il)
        ff_r = features_r if features_r is not None else self._extract(ir)
        self._depth = self._stereo_match(ff_l, ff_r)
        if il is not None and ir is not None:
            self._depth = self._refine(il, ir, ff_l.xy, self._depth)
        return ff_l

    def track_stereo(self, img_l, img_r, ts: float,
                     features_l: FeatureFrame | None = None,
                     features_r: FeatureFrame | None = None):
        """One stereo pair (uint8 images, or features on the System's
        device).  Returns (state, (Rwc, twc) in numpy or None)."""
        ff_l = self._pair_depth(img_l, img_r, features_l, features_r)
        return self._track_with_depth(ff_l, ts)

    def _track_with_depth(self, ff_l: FeatureFrame, ts: float):
        """The depth sensors' frame step; `self._depth` holds the frame's
        per-keypoint depth (from a pair or from a depth image)."""
        self.frame_id += 1
        if self.state in (base.NO_IMAGES_YET, base.NOT_INITIALIZED):
            self._stereo_initialize(ff_l, ts)
        elif self.state in (base.OK, base.RECENTLY_LOST):
            self._track_frame(ff_l, ts)
        out = None
        if self.state == base.OK:
            R_cw, t_cw = self._pose_numpy()
            Rwc = R_cw.T
            twc = -Rwc @ t_cw
            self.trajectory.append((ts, Rwc, twc))
            out = (Rwc, twc)
        if self.viewer is not None:
            self.viewer.publish(self)
            self.viewer.wait_if_paused()
        return self.state, out

    # ----------------------------------------------------------------- init
    def _stereo_initialize(self, ff: FeatureFrame, ts: float) -> None:
        """The map from one frame's depths: keyframe 0 at the origin and a
        point per keypoint with a depth.  Reads the depth count."""
        cfg, dev = self.cfg, self.device
        d = self._depth
        ok = d.valid & ff.valid
        n_ok = int(torch.sum(ok))
        if n_ok < self.scfg.min_init_depth_points:
            return
        sfac, nl = cfg.orb.scale_factor, cfg.orb.n_levels
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        m = mapstate.empty_map(cfg.map_capacity, dev)
        m, k0 = mapstate.add_keyframe(m, eye, zero, ts, self.frame_id)
        X = self._depth_rays(ff) * d.depth[:, None]
        dist = torch.linalg.norm(X, dim=1)
        sf = sfac ** ff.octave.to(torch.float32)
        m, pt_idx = mapstate.add_points(
            m, X, ff.desc, X / torch.clamp_min(dist, 1e-9)[:, None],
            dist * sf / (sfac ** (nl - 1)), dist * sf, 0, self.frame_id, ok)
        ur = torch.where(d.valid, d.ur, -1.0)
        m = mapstate.add_observations(m, k0, pt_idx, ff.xy, ff.octave, ok, ur=ur)
        self.map = m
        self._set_pose(eye, zero)
        self.R_prev, self.t_prev = eye, zero
        self.has_velocity = False
        self.state = base.OK
        self.last_kf_id = self.frame_id
        # a fresh map: its keyframe sits at slot 0
        self.last_kf_idx = 0
        self.n_kf_host = 1
        self.last_kf_ts = ts
        self._bank_store(0, ff, torch.where(ok, pt_idx, -1), ur=ur)
        self.inliers_at_last_kf = n_ok
        self._refresh_view()

    def _frame_kp_ur(self, ff: FeatureFrame) -> torch.Tensor:
        d = self._depth
        return torch.where(d.valid, d.ur, -1.0)

    def _depth_rays(self, ff: FeatureFrame) -> torch.Tensor:
        """Camera rays with z = 1 per keypoint, for depth back-projection
        (the pinhole ray is that already; a KB8 bearing is rescaled)."""
        rays = cameras.unproject(self.cfg.cam_model, self.cam_params, ff.xy)
        return rays / torch.clamp_min(rays[:, 2:3], 1e-6)

    # ------------------------------------------------------------- keyframe
    def _insert_keyframe(self, ff: FeatureFrame, tr, ts: float, n_inl: int):
        super()._insert_keyframe(ff, tr, ts, n_inl)
        self._stereo_new_points(ff)
        # the depth-made points are tracked from the next frame on
        self._refresh_view()

    def _stereo_new_points(self, ff: FeatureFrame) -> None:
        """Depth-made points for the last keyframe's unbound keypoints.  With
        `async_mapping` they are appended after the snapshot that the
        pending chain optimizes, and `merge_opt` keeps them."""
        ki = self.last_kf_idx
        self.map, self.bank, _ = stereo_new_points(
            self.cfg, self.map, self.bank, ki, ff, _row(self.bank.kp_pt, ki), self._depth,
            self._depth_rays(ff), self.frame_id)
