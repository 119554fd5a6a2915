"""A camera path over the textured plane with mesas, rendered on the device
from the seed (`scene.Sequence`), with the configuration's IMU where it has
one."""

from __future__ import annotations

from slambench import scene


def make(traffic: dict, config: dict, seed: int, device):
    num = config["preset_numbers"]
    imu = num.get("imu")
    return scene.Sequence(traffic, num, seed, device, imu_noise=imu,
                          Tbc=imu["Tbc"] if imu else None)
