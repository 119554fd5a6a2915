"""Kernel launches a frame of the IMU preintegration: those whose launching
runtime call ran inside a `preintegrate` span
(`InertialSystem._preint_rows` around `ops/imu.preintegrate`: the frame's
interval, the factor since the last keyframe, a keyframe's interval) in the
profiled slice, over the slice's frames.  Read through
`slambench/spans.py`."""

from slambench import spans

spans.install()


def read(ctx):
    return spans.launches_per_frame(ctx, "preintegrate", frames_that_ran_one=False)
