"""Host seconds of the set-up's IMU stages: every `imu_init` span
(`InertialSystem._initialize_imu`: the inertial-only initialization, the
reintegration and the full inertial BA; the IMU init and VIBA1 here) in the
frames before the window.  Read through `slambench/spans.py`."""

from slambench import spans

spans.install()


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    v = [(s.end_ns - s.start_ns) / 1e9 for s in w.spans if s.name == "imu_init"
         and s.end_ns is not None and s.frame is not None and s.frame < w.first]
    return sum(v) if v else None
