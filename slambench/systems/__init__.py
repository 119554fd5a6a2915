"""The systems a configuration can name (`"system": "<name>"`): the module
`systems/<name>.py` with `build(config, device, seed, overrides)`, which
returns the port's System of the configuration's preset, and `feed(system,
sequence, i)`, which hands it frame i and returns what the entry returns."""

from __future__ import annotations

import importlib

import numpy as np


def load(name: str):
    return importlib.import_module(f"slambench.systems.{name}")


def preset_checked(config: dict, overrides: dict):
    """The configuration's preset (`orbslam3_tpu_torch.config.<preset>`,
    with a test's `overrides`), after checking that it still has the numbers
    the configuration states.  A preset returns a SlamConfig or a tuple that
    starts with one, then an InertialConfig and a StereoConfig where it has
    them, then any rectification maps; the whole return goes back to the
    system module.  A configuration states `imu` (the Tbc that maps the
    tracked camera, rectified where the pair is, to the body) for an
    inertial preset and `stereo` (`baseline` and `max_depth_factor`, the
    StereoConfig's, and `stereo_bf`, the SlamConfig's; the reference's
    association gates follow from them) for a stereo one."""
    from orbslam3_tpu_torch import config as presets
    from orbslam3_tpu_torch.pipeline import inertial_system, stereo_system

    out = getattr(presets, config["preset"])(**overrides)
    parts = out if isinstance(out, tuple) else (out,)
    cfg = parts[0]
    icfg = next((p for p in parts if isinstance(p, inertial_system.InertialConfig)), None)
    scfg = next((p for p in parts if isinstance(p, stereo_system.StereoConfig)), None)
    stated = config["preset_numbers"]
    found = dict(cam_params=list(cfg.cam_params), image_hw=list(cfg.image_hw),
                 **{k: getattr(cfg.orb, k) for k in stated["orb"]},
                 max_frames_between_kf=cfg.max_frames_between_kf)
    want = dict(cam_params=stated["cam_params"], image_hw=stated["image_hw"], **stated["orb"],
                max_frames_between_kf=stated["max_frames_between_kf"])
    if icfg is not None:
        for k in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "imu_freq",
                  "init_time_s", "init_min_kfs"):
            found[k], want[k] = getattr(icfg, k), stated["imu"][k]
        found["Tbc"], want["Tbc"] = list(icfg.Tbc), stated["imu"]["Tbc"]
    if scfg is not None:
        for k in dict.fromkeys(("baseline", "max_depth_factor", "stereo_bf", *stated["stereo"])):
            found[k], want[k] = getattr(cfg if k == "stereo_bf" else scfg, k), stated["stereo"][k]
    for k, v in want.items():
        if not np.allclose(np.asarray(found[k], np.float64), np.asarray(v, np.float64),
                           rtol=1e-9, atol=0):
            raise RuntimeError(f"the preset {config['preset']} has {k} = {found[k]}, "
                               f"the configuration states {v}")
    return out
