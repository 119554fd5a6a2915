"""Stereo-inertial SLAM (the TUM-VI room configuration's kind).

Counterpart of `orbslam3_tpu/pipeline/stereo_inertial_system.py`: the
stereo front end (metric initialization from one pair, depth-made points, ur
residuals) with the inertial machinery (preintegration, the IMU prediction,
the VI window BA) and the inertial initialization at a fixed scale (the
reference passes bFixedScale for stereo-inertial, src/Optimizer.cc:2964):
the scale is metric from the stereo pair, the IMU solves gravity, biases and
velocities.
"""

from __future__ import annotations

from ..features.extractor import FeatureFrame
from . import inertial_system, stereo_system, system as base


class StereoInertialSystem(inertial_system.InertialSystem):
    imu_fix_scale = True

    def __init__(self, config: base.SlamConfig, icfg: inertial_system.InertialConfig,
                 scfg: stereo_system.StereoConfig, device=None, seed: int = 42):
        super().__init__(config, icfg, device=device, seed=seed)
        self.scfg = scfg
        stereo_system.StereoSystem._build_stereo_matchers(self, config, scfg)

    # the stereo front end's pieces
    _pair_depth = stereo_system.StereoSystem._pair_depth
    _stereo_initialize = stereo_system.StereoSystem._stereo_initialize
    _frame_kp_ur = stereo_system.StereoSystem._frame_kp_ur
    _depth_rays = stereo_system.StereoSystem._depth_rays
    _stereo_new_points = stereo_system.StereoSystem._stereo_new_points

    def _insert_keyframe(self, ff, tr, ts, n_inl):
        super()._insert_keyframe(ff, tr, ts, n_inl)
        self._stereo_new_points(ff)
        self._refresh_view()

    def track_stereo(self, img_l, img_r, ts: float,
                     features_l: FeatureFrame | None = None,
                     features_r: FeatureFrame | None = None):
        """One stereo pair after its IMU samples (`grab_imu`).  Returns
        (state, (Rwc, twc) in numpy or None)."""
        ff_l = self._pair_depth(img_l, img_r, features_l, features_r)
        self._frame_rows = self._interval_rows(self.last_frame_ts, ts)
        self.last_frame_ts = ts
        self.frame_id += 1
        if self.state in (base.NO_IMAGES_YET, base.NOT_INITIALIZED):
            self._stereo_initialize(ff_l, ts)
            if self.state == base.OK:
                self.last_body = self._cam_to_body(self.R_cur, self.t_cur)
        elif self.state in (base.OK, base.RECENTLY_LOST):
            self._track_frame(ff_l, ts)
        if self.state != base.OK:
            return self.state, None
        R_cw, t_cw = self._pose_numpy()
        Rwc = R_cw.T
        twc = -Rwc @ t_cw
        self.trajectory.append((ts, Rwc, twc))
        return self.state, (Rwc, twc)
