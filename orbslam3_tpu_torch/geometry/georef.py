"""GNSS georeferencing: align the SLAM trajectory to GNSS fixes.

Counterpart of `orbslam3_tpu/geometry/georef.py` (parity target: the fork's
GeometricReferencer, reference src/GeometricReferencer.cpp:119-166): a
sliding window of keyframe positions with their GNSS fixes; the Sim3 from
SLAM positions to the GNSS frame (EPSG3857 planar coordinates, reference
ros2_ws include/conversions.hpp) by Umeyama with scale once `min_kfs` fixes
are in and the positions spread; `apply` carries SLAM coordinates into the
geo frame.  The GNSS-constrained BA (Optimizer::LocalGNSSBundleAdjustment,
src/Optimizer.cc:1362) is the COO bundle adjuster with position priors
(`mapping.run_local_ba(prior_pos=)`).

The window is float32 numpy on the host, as in JAX, and the fit runs on CPU
tensors: every input of it comes from the host and every use of its result
(the priors of the GNSS BA, `System.trajectory_geo`) is on the host, so on
the card it would only add an upload and reads.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import align

WGS84_A = 6378137.0


def wgs84_to_epsg3857(lat_deg: np.ndarray, lon_deg: np.ndarray):
    """Web-mercator conversion (reference include/epsg3857.hpp)."""
    x = WGS84_A * np.radians(lon_deg)
    y = WGS84_A * np.log(np.tan(np.pi / 4 + np.radians(lat_deg) / 2))
    return x, y


class GeorefTransform(NamedTuple):
    R: torch.Tensor   # (3, 3)
    t: torch.Tensor   # (3,)
    s: torch.Tensor   # ()
    valid: bool


@dataclasses.dataclass
class GeometricReferencer:
    """Sliding-window Umeyama alignment SLAM -> GNSS frame."""
    min_kfs: int = 10
    window: int = 50
    # degenerate-geometry guard: the least spread (norm of the per-axis
    # standard deviations) of the SLAM positions before a fit, in SLAM
    # units (a monocular map is median-depth normalized, so it is small)
    min_spread: float = 0.1
    _slam: list = dataclasses.field(default_factory=list)
    _gnss: list = dataclasses.field(default_factory=list)
    transform: GeorefTransform | None = None

    def add_fix(self, slam_pos, gnss_pos):
        self._slam.append(np.asarray(slam_pos, np.float32))
        self._gnss.append(np.asarray(gnss_pos, np.float32))
        if len(self._slam) > self.window:
            self._slam.pop(0)
            self._gnss.pop(0)

    @property
    def initialized(self) -> bool:
        return self.transform is not None

    def update(self) -> GeorefTransform | None:
        """Re-estimate the Sim3 if enough fixes are buffered."""
        if len(self._slam) < self.min_kfs:
            return self.transform
        src = torch.from_numpy(np.stack(self._slam))
        dst = torch.from_numpy(np.stack(self._gnss))
        if float(torch.linalg.norm(torch.std(src, dim=0, correction=0))) < self.min_spread:
            return self.transform
        R, t, s = align.umeyama_alignment(src, dst, with_scale=True)
        self.transform = GeorefTransform(R=R, t=t, s=s, valid=True)
        return self.transform

    def apply(self, xyz: torch.Tensor) -> torch.Tensor:
        """SLAM coordinates -> geo frame (reference GeometricReferencer::apply)."""
        if self.transform is None:
            return xyz
        T = self.transform
        return T.s * xyz @ T.R.T + T.t


def gnss_position_residuals(pwb: torch.Tensor, gnss: torch.Tensor, has_fix: torch.Tensor,
                            sigma: float = 1.0) -> torch.Tensor:
    """(K, 3) weighted position residuals of the GNSS-constrained BA (unary
    priors on keyframe positions in the geo frame, the fork's
    LocalGNSSBundleAdjustment edges)."""
    w = has_fix.to(torch.float32)[:, None] / sigma
    return (pwb - gnss) * w
