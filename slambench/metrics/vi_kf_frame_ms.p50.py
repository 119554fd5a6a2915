"""Host median, in ms, of the window's inertial keyframe frames that ran no
IMU stage (initialization, VIBA1, VIBA2): tracking plus the keyframe step
with the visual-inertial window BA."""

import statistics


def read(ctx):
    v = [f.seconds * 1e3 for f in ctx["frames"] if f.ok and f.keyframe and not f.imu_stage]
    return statistics.median(v) if v else None
