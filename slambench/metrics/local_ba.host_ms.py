"""Host median, in ms, of one window BA of the keyframe step
(`pipeline/system.local_ba` -> `mapping.run_local_ba` -> `solver/ba_grid`)
over the window's keyframes."""

import statistics

RANGES = [("orbslam3_tpu_torch.pipeline.system", "local_ba", "local_ba")]


def read(ctx):
    v = [s * 1e3 for _, s in ctx["ranges"].get("local_ba", ())]
    return statistics.median(v) if v else None
