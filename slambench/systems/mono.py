"""The monocular System of a configuration's preset: `track_monocular`
for each frame."""

from __future__ import annotations

from slambench.systems import preset_checked


def build(config: dict, device, seed: int, overrides: dict):
    from orbslam3_tpu_torch.pipeline import system
    cfg = preset_checked(config, overrides)
    return system.System(cfg, device=device, seed=seed)


def feed(sys_, seq, i: int):
    return sys_.track_monocular(seq.frames[i], seq.ts[i])
