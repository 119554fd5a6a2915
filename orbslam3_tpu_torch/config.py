"""Dataset and sensor configuration presets.

Counterpart of `orbslam3_tpu/config.py`, returning the port's config
objects.  Parity target: the reference's Settings and its per-dataset YAML
calibrations (upstream EuRoC / TUM-VI: 1000-1200 features, 8 levels, scale
factor 1.2, FAST 20/7).  Each preset returns the configuration objects of
the System class that it is for:

  euroc_mono, tumvi_mono               SlamConfig          -> System
  euroc_mono_inertial,
  tumvi_mono_inertial                  (cfg, icfg)         -> InertialSystem
  euroc_stereo, euroc_rgbd             (cfg, scfg)         -> StereoSystem / RGBDSystem
  euroc_stereo_rectified               (cfg, scfg, map0, map1)
  euroc_stereo_inertial,
  tumvi_stereo_inertial                (cfg, icfg, scfg, map0, map1)
                                                           -> StereoInertialSystem

`map0` / `map1` are the rectification maps of the raw left and right images
(`io.euroc.apply_undistort`).
"""

from __future__ import annotations

import numpy as np

from .features.extractor import OrbParams
from .io import euroc as euroc_io
from .io import rectify
from .pipeline import inertial_system, stereo_system, system as base_sys


def euroc_mono(**overrides) -> base_sys.SlamConfig:
    """EuRoC cam0 monocular (on radtan-undistorted images)."""
    cam = euroc_io.EUROC_CAM0
    cfg = dict(
        cam_model="pinhole", cam_params=cam["params"],
        image_hw=cam["resolution"],
        orb=OrbParams(n_features=1200, n_levels=8, scale_factor=1.2,
                      ini_th_fast=20.0, min_th_fast=7.0),
        max_frames_between_kf=int(cam["rate_hz"]),
    )
    cfg.update(overrides)
    return base_sys.SlamConfig(**cfg)


def euroc_mono_inertial(**overrides):
    """EuRoC monocular-inertial: SlamConfig + InertialConfig."""
    imu = euroc_io.EUROC_IMU
    icfg = inertial_system.InertialConfig(
        imu_freq=imu["rate_hz"],
        noise_gyro=imu["noise_gyro"], noise_acc=imu["noise_acc"],
        walk_gyro=imu["walk_gyro"], walk_acc=imu["walk_acc"],
        Tbc=tuple(imu["Tbc"].reshape(-1).tolist()),
        init_time_s=2.0, init_min_kfs=6)
    return euroc_mono(**overrides), icfg


def euroc_stereo(**overrides):
    """EuRoC stereo (pre-rectified input pairs)."""
    cam = euroc_io.EUROC_CAM0
    baseline = 0.110074  # EuRoC cam0-cam1 baseline after rectification
    cfg = euroc_mono(stereo_bf=cam["params"][0] * baseline, **overrides)
    scfg = stereo_system.StereoConfig(baseline=baseline)
    return cfg, scfg


def euroc_stereo_rectified(**overrides):
    """EuRoC stereo from RAW cam0/cam1: rectification maps computed from
    the factory calibration (upstream Settings::precomputeRectificationMaps
    parity — reference include/Settings.h:32-94).

    Returns (cfg, scfg, map0, map1): map0 / map1 for
    euroc_io.apply_undistort; cfg.cam_params / stereo_bf are the shared
    rectified intrinsics.
    """
    c0, c1 = euroc_io.EUROC_CAM0, euroc_io.EUROC_CAM1
    R, t = rectify.relative_pose_from_body(c0["T_BS"], c1["T_BS"])
    map0, map1, new_k4, baseline, _, _ = rectify.stereo_rectify(
        c0["params"], c0["distortion"], c1["params"], c1["distortion"],
        R, t, c0["resolution"])
    cfg = euroc_mono(cam_params=new_k4,
                     stereo_bf=new_k4[0] * baseline, **overrides)
    scfg = stereo_system.StereoConfig(baseline=baseline)
    return cfg, scfg, map0, map1


def euroc_stereo_inertial(**overrides):
    """EuRoC stereo-inertial (reference Examples/Stereo-Inertial EuRoC
    configuration): RAW cam0/cam1 through calibration-derived
    rectification + IMU with fixed-scale inertial init.

    Returns (cfg, icfg, scfg, map0, map1); Tbc in icfg is composed with
    the left rectifying rotation (body <- RECTIFIED left camera), same
    construction as tumvi_stereo_inertial.
    """
    c0, c1 = euroc_io.EUROC_CAM0, euroc_io.EUROC_CAM1
    R, t = rectify.relative_pose_from_body(c0["T_BS"], c1["T_BS"])
    map0, map1, new_k4, baseline, R1, _ = rectify.stereo_rectify(
        c0["params"], c0["distortion"], c1["params"], c1["distortion"],
        R, t, c0["resolution"])
    cfg = euroc_mono(cam_params=new_k4,
                     stereo_bf=new_k4[0] * baseline, **overrides)
    T_rc = np.eye(4)
    T_rc[:3, :3] = np.asarray(R1, np.float64).T
    Tbc = euroc_io.EUROC_IMU["Tbc"] @ T_rc
    imu = euroc_io.EUROC_IMU
    icfg = inertial_system.InertialConfig(
        imu_freq=imu["rate_hz"],
        noise_gyro=imu["noise_gyro"], noise_acc=imu["noise_acc"],
        walk_gyro=imu["walk_gyro"], walk_acc=imu["walk_acc"],
        Tbc=tuple(Tbc.reshape(-1).tolist()),
        init_time_s=2.0, init_min_kfs=6)
    scfg = stereo_system.StereoConfig(baseline=baseline)
    return cfg, icfg, scfg, map0, map1


def euroc_rgbd(baseline: float = 0.08, **overrides):
    """RGB-D on EuRoC-style calibration (undistorted cam0 pinhole +
    aligned metric depth).  The virtual-rig baseline sets the ur
    residual's scale sensitivity only (reference reads Camera.bf from
    the RGB-D yaml — Frame::ComputeStereoFromRGBD).

    Returns (cfg, scfg)."""
    cam = euroc_io.EUROC_CAM0
    cfg = euroc_mono(stereo_bf=cam["params"][0] * baseline, **overrides)
    scfg = stereo_system.StereoConfig(baseline=baseline)
    return cfg, scfg


def tumvi_mono(**overrides) -> base_sys.SlamConfig:
    """TUM-VI room (fisheye Kannala-Brandt, 512x512)."""
    cam = euroc_io.TUMVI_CAM0
    cfg = dict(
        cam_model="kb8", cam_params=cam["params"],
        image_hw=cam["resolution"],
        orb=OrbParams(n_features=1000, n_levels=8, scale_factor=1.2,
                      ini_th_fast=20.0, min_th_fast=7.0),
        max_frames_between_kf=int(cam["rate_hz"]),
    )
    cfg.update(overrides)
    return base_sys.SlamConfig(**cfg)


def tumvi_mono_inertial(**overrides):
    """TUM-VI monocular-inertial (BMI160 IMU @200 Hz)."""
    imu = euroc_io.TUMVI_IMU
    icfg = inertial_system.InertialConfig(
        imu_freq=200.0, noise_gyro=imu["noise_gyro"],
        noise_acc=imu["noise_acc"],
        walk_gyro=imu["walk_gyro"], walk_acc=imu["walk_acc"],
        Tbc=tuple(imu["Tbc"].reshape(-1).tolist()),
        init_time_s=2.0, init_min_kfs=6)
    return tumvi_mono(**overrides), icfg


def tumvi_stereo_inertial(**overrides):
    """TUM-VI stereo-inertial (the JAX package's flagship fisheye
    configuration).

    The KB8 fisheye pair is rectified to a shared virtual pinhole
    (io/rectify.stereo_rectify with the equidistant model: the stereo
    matcher works on row-aligned pairs; upstream instead matches raw
    fisheye across cameras via Stereo.T_c1_c2, and
    `StereoConfig.raw_fisheye` does that here).  The scale is metric from
    stereo, so the inertial init runs at a fixed scale (reference
    bFixedScale, src/Optimizer.cc:2964).

    Returns (cfg, icfg, scfg, map0, map1): map0 / map1 for
    euroc_io.apply_undistort; Tbc in icfg is already composed with the
    rectifying rotation (body <- RECTIFIED left camera).
    """
    c0, c1 = euroc_io.TUMVI_CAM0, euroc_io.TUMVI_CAM1
    R, t = rectify.relative_pose_from_body(c0["T_BS"], c1["T_BS"])
    map0, map1, new_k4, baseline, R1, _ = rectify.stereo_rectify(
        c0["params"][:4], c0["params"][4:],
        c1["params"][:4], c1["params"][4:],
        R, t, c0["resolution"], model="kb8")
    cfg = dict(
        cam_model="pinhole", cam_params=new_k4,
        image_hw=c0["resolution"],
        orb=OrbParams(n_features=1000, n_levels=8, scale_factor=1.2,
                      ini_th_fast=20.0, min_th_fast=7.0),
        max_frames_between_kf=int(c0["rate_hz"]),
        stereo_bf=new_k4[0] * baseline,
    )
    cfg.update(overrides)
    cfg = base_sys.SlamConfig(**cfg)
    # rectification rotates the camera frame: compose the extrinsic so
    # Tbc maps RECTIFIED-left-camera coords into the body frame
    T_rc = np.eye(4)
    T_rc[:3, :3] = np.asarray(R1, np.float64).T
    Tbc = euroc_io.TUMVI_IMU["Tbc"] @ T_rc
    imu = euroc_io.TUMVI_IMU
    icfg = inertial_system.InertialConfig(
        imu_freq=200.0, noise_gyro=imu["noise_gyro"],
        noise_acc=imu["noise_acc"],
        walk_gyro=imu["walk_gyro"], walk_acc=imu["walk_acc"],
        Tbc=tuple(Tbc.reshape(-1).tolist()),
        init_time_s=2.0, init_min_kfs=6)
    scfg = stereo_system.StereoConfig(baseline=baseline)
    return cfg, icfg, scfg, map0, map1
