"""Share of the tracking layer's pose optimizations in the window's frames
that ran as a CUDA graph rather than eagerly: the program's counters
`graph.replay / (graph.replay + graph.eager)`, one of `graph.eager`,
`graph.capture` or `graph.replay` for each call of
`solver/pose_opt.pose_optimization`, `solver/vi_pose_opt.vi_pose_optimization`
and `vi_pose_optimization_last_frame` (`utils/graphs.py`).  A capture runs
its graph too and is left out of both.  None where no replay or eager call
was counted (a program without the graphs).  Read through
`slambench/spans.py`."""

from slambench import spans

spans.install()


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    n = {k: sum(w.counters.get("graph." + k, {}).get(f, 0) for f in w.frames)
         for k in ("replay", "eager")}
    calls = n["replay"] + n["eager"]
    return n["replay"] / calls if calls else None
