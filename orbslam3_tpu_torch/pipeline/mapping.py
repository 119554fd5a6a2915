"""Local mapping: for now only the point statistics that seed a map.

Counterpart of `orbslam3_tpu/pipeline/mapping.py`; keyframe insertion,
triangulation and local BA are ported with the keyframe step.
"""

from __future__ import annotations

import torch


def point_descriptor_stats(X, desc, kf_center, octave, scale_factor: float,
                           n_levels: int):
    """Normal + scale range for freshly created points (reference
    MapPoint::UpdateNormalAndDepth, src/MapPoint.cc:440)."""
    sf = scale_factor ** torch.clamp(octave, 0, n_levels - 1).to(torch.float32)
    view = X - kf_center
    dist = torch.linalg.norm(view, dim=-1)
    normal = view / torch.clamp_min(dist, 1e-9)[:, None]
    max_dist = dist * sf
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    return normal, min_dist, max_dist
