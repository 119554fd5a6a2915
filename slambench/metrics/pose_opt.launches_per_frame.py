"""Kernel launches a frame of the pose-only optimization: those whose
launching runtime call ran inside a `pose_opt` span
(`pipeline/tracking.track_local_map` around `solver/pose_opt`) in the
profiled slice, over the slice's frames that ran one.  Read through
`slambench/spans.py`."""

from slambench import spans

spans.install()


def read(ctx):
    return spans.launches_per_frame(ctx, "pose_opt", frames_that_ran_one=True)
