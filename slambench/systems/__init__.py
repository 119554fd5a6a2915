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
    the configuration states."""
    from orbslam3_tpu_torch import config as presets

    out = getattr(presets, config["preset"])(**overrides)
    cfg, icfg = out if isinstance(out, tuple) else (out, None)
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
    for k, v in want.items():
        if not np.allclose(np.asarray(found[k], np.float64), np.asarray(v, np.float64),
                           rtol=1e-9, atol=0):
            raise RuntimeError(f"the preset {config['preset']} has {k} = {found[k]}, "
                               f"the configuration states {v}")
    return out
