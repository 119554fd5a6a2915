"""The stereo-inertial System of a configuration's preset: `grab_imu` for
each IMU sample of the frame's interval, then `track_stereo` on the
rectified pair (the sequence's `frames` and `right`).  The preset's
rectification maps go unused: the pair generator renders the pair already
rectified."""

from __future__ import annotations

from slambench.systems import preset_checked


def build(config: dict, device, seed: int, overrides: dict):
    from orbslam3_tpu_torch.pipeline import stereo_inertial_system
    cfg, icfg, scfg = preset_checked(config, overrides)[:3]
    return stereo_inertial_system.StereoInertialSystem(cfg, icfg, scfg, device=device, seed=seed)


def feed(sys_, seq, i: int):
    for s in seq.imu[i]:
        sys_.grab_imu(*s)
    return sys_.track_stereo(seq.frames[i], seq.right[i], seq.ts[i])
