"""Host median, in ms, of one `pipeline/tracking.track_local_map` call over
the window: projection gates, the Hamming matcher and the pose-only
Gauss-Newton."""

import statistics

RANGES = [("orbslam3_tpu_torch.pipeline.tracking", "track_local_map", "track_local_map")]


def read(ctx):
    v = [s * 1e3 for _, s in ctx["ranges"].get("track_local_map", ())]
    return statistics.median(v) if v else None
