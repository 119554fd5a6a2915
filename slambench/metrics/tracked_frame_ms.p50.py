"""Host median, in ms, of the window's tracked frames that inserted no
keyframe: `System.track_monocular` from the call until the pose is back."""

import statistics


def read(ctx):
    v = [f.seconds * 1e3 for f in ctx["frames"] if f.ok and not f.keyframe and not f.imu_stage]
    return statistics.median(v) if v else None
