"""The per-frame monocular step: extract, predict, track, count.

Line-for-line counterpart of `slam_frame` in `bench.py:138-149` (the step
`System._track` / `System._track_frame` run on every camera frame):
ORB extraction, a constant-velocity pose guess, local-map tracking
against the bounded view, and the map points' visible/found counters.
No value is read back to the host.
"""

from __future__ import annotations

from ..features.extractor import FeatureFrame, OrbParams, extract
from ..ops import lie
from ..slam_map.state import MapState, PointView
from . import tracking


def track_frame(m: MapState, view: PointView, img, R_prev, t_prev, R_cur, t_cur,
                p: OrbParams, cam, hw: tuple[int, int], radius_th: float = 4.0):
    """Returns (map with updated counters, FeatureFrame, R_cw, t_cw, kp_pt,
    n_inliers), as `slam_frame` does."""
    return track_features(m, view, extract(img, p), R_prev, t_prev, R_cur, t_cur, p, cam, hw,
                          radius_th)


def track_features(m: MapState, view: PointView, ff: FeatureFrame, R_prev, t_prev, R_cur,
                   t_cur, p: OrbParams, cam, hw: tuple[int, int], radius_th: float = 4.0):
    """`track_frame` after the extraction, on the frame's features."""
    # constant-velocity guess
    Rpi, tpi = lie.se3_inverse(R_prev, t_prev)
    Rv, tv = lie.se3_compose(R_cur, t_cur, Rpi, tpi)
    Rg, tg = lie.se3_compose(Rv, tv, R_cur, t_cur)
    tr = tracking.track_local_map(
        m, ff, Rg, tg, "pinhole", cam, hw, p.scale_factor, p.n_levels,
        radius_th=radius_th, view=view)
    m2 = tracking.update_point_stats(m, tr)
    return m2, ff, tr.R, tr.t, tr.kp_pt, tr.n_inliers
