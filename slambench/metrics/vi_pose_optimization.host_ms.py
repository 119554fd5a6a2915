"""Host median, in ms per frame, of the visual-inertial pose optimizations
of `solver/vi_pose_opt` (the LastKeyFrame and the LastFrame variants
together) over the window's frames that ran one."""

import collections
import statistics

RANGES = [("orbslam3_tpu_torch.solver.vi_pose_opt", "vi_pose_optimization", "vi_pose_optimization"),
          ("orbslam3_tpu_torch.solver.vi_pose_opt", "vi_pose_optimization_last_frame",
           "vi_pose_optimization_last_frame")]


def read(ctx):
    per = collections.Counter()
    for name in ("vi_pose_optimization", "vi_pose_optimization_last_frame"):
        for frame, s in ctx["ranges"].get(name, ()):
            per[frame] += s * 1e3
    return statistics.median(per.values()) if per else None
