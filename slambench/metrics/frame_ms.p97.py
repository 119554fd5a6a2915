"""97th percentile, in ms, of all the window's frame latencies (the call
until the pose is back on the host): the latency tail, which the keyframe
frames (1 in ~20) make.  From run to run it moves with the host's speed,
by more than an end-to-end bound may allow, so it is read per layer
(PERF.md, section 2)."""

import numpy as np


def read(ctx):
    v = [f.seconds * 1e3 for f in ctx["frames"]]
    return float(np.percentile(v, 97)) if v else None
