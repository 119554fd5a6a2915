"""Host median, in ms, of the window's inertial tracked frames that
inserted no keyframe and ran no IMU stage: `InertialSystem.track_monocular`
after `grab_imu` of the interval's samples."""

import statistics


def read(ctx):
    v = [f.seconds * 1e3 for f in ctx["frames"] if f.ok and not f.keyframe and not f.imu_stage]
    return statistics.median(v) if v else None
