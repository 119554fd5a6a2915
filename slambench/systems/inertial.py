"""The monocular-inertial System of a configuration's preset: `grab_imu`
for each IMU sample of the frame's interval, then `track_monocular`."""

from __future__ import annotations

from slambench.systems import preset_checked


def build(config: dict, device, seed: int, overrides: dict):
    from orbslam3_tpu_torch.pipeline import inertial_system
    cfg, icfg = preset_checked(config, overrides)
    return inertial_system.InertialSystem(cfg, icfg, device=device, seed=seed)


def feed(sys_, seq, i: int):
    for s in seq.imu[i]:
        sys_.grab_imu(*s)
    return sys_.track_monocular(seq.frames[i], seq.ts[i])
