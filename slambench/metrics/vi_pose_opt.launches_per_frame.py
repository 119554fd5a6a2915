"""Kernel launches a frame of the visual-inertial pose optimizations: those
whose launching runtime call ran inside a `vi_pose_opt` span
(`InertialSystem._vi_track_step` around `solver/vi_pose_opt`, both
variants) in the profiled slice, over the slice's frames that ran one.
Read through `slambench/spans.py`."""

from slambench import spans

spans.install()


def read(ctx):
    return spans.launches_per_frame(ctx, "vi_pose_opt", frames_that_ran_one=True)
