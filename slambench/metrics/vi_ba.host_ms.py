"""Host median, in ms, of one visual-inertial BA
(`solver/vi_ba.vi_bundle_adjust`, the keyframe step's window BA once the
IMU is initialized) over the window's keyframes."""

import statistics

RANGES = [("orbslam3_tpu_torch.solver.vi_ba", "vi_bundle_adjust", "vi_ba")]


def read(ctx):
    v = [s * 1e3 for _, s in ctx["ranges"].get("vi_ba", ())]
    return statistics.median(v) if v else None
