"""Host median, in ms, of the window's keyframe frames (the System's
`n_kf_host` rose during the call): tracking plus the keyframe step."""

import statistics


def read(ctx):
    v = [f.seconds * 1e3 for f in ctx["frames"] if f.ok and f.keyframe and not f.imu_stage]
    return statistics.median(v) if v else None
