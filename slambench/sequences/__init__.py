"""The sequence generators a traffic file can name (`"generator": "<name>"`):
the module `sequences/<name>.py` with `make(traffic, config, seed,
device)`, which returns a `scene.Sequence`-like object: `n`, `ts`,
`frames` (host memory), `centers`, `path` (`pose64(t)`) and,
for a configuration with an IMU, `imu[i]`, the samples of frame i's
interval; a pair's generator adds `right`, the right images beside
`frames`."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"slambench.sequences.{name}")
