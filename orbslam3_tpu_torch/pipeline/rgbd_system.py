"""RGB-D SLAM: the depth-image sensor on the stereo pipeline.

Counterpart of `orbslam3_tpu/pipeline/rgbd_system.py` (reference System's
RGBD sensor, include/System.h:61-68).  As upstream's
Frame::ComputeStereoFromRGBD, the depth image becomes a virtual right
coordinate per keypoint, ur = u - bf / z, after which everything (metric
initialization, depth-made points, the third residual row in the bundle
adjusters, the fixed-scale Sim3 of loop closing) is the stereo path's.  The
virtual rig's baseline only sets the scale of the ur residual, and it must be
the same bf as `SlamConfig.stereo_bf`, which weighs that residual.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.extractor import FeatureFrame
from ..features.stereo import StereoDepth
from . import stereo_system


def depth_from_image(ff: FeatureFrame, depth_img: torch.Tensor, bf: float,
                     max_depth: float) -> StereoDepth:
    """The depth image sampled at each keypoint's nearest pixel (the
    reference rounds with cvRound; `torch.round`, as `jnp.round`, rounds
    half to even) and its virtual right-u."""
    H, W = depth_img.shape
    u = torch.clamp(torch.round(ff.xy[:, 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(ff.xy[:, 1]).to(torch.int64), 0, H - 1)
    z = depth_img[v, u]
    ok = ff.valid & torch.isfinite(z) & (z > 0.0) & (z < max_depth)
    ur = ff.xy[:, 0] - bf / torch.clamp_min(z, 1e-6)
    return StereoDepth(ur=torch.where(ok, ur, -1.0), depth=torch.where(ok, z, 0.0), valid=ok)


class RGBDSystem(stereo_system.StereoSystem):
    def __init__(self, config, scfg: stereo_system.StereoConfig, device=None, seed: int = 42):
        super().__init__(config, scfg, device=device, seed=seed)
        self.bf = float(config.cam_params[0]) * scfg.baseline
        # the BA weighs ur residuals by cfg.stereo_bf while the virtual ur
        # here is made with fx * baseline: the same quantity (the reference's
        # Camera.bf feeds both), or ur residuals are silently mis-weighted
        if abs(config.stereo_bf - self.bf) > 1e-4 * max(self.bf, 1.0):
            raise ValueError(f"RGBDSystem: config.stereo_bf={config.stereo_bf} != "
                             f"fx*baseline={self.bf}; set stereo_bf=fx*baseline")
        self.max_depth = scfg.max_depth_factor * scfg.baseline * 3

    def track_rgbd(self, img, depth, ts: float, features: FeatureFrame | None = None):
        """One RGB-D frame: a uint8 image (or its features on the System's
        device) and the metric depth image aligned to it."""
        with self._next_frame():
            ff = features if features is not None else self._extract(img)
            if not isinstance(depth, torch.Tensor):
                depth = np.asarray(depth, np.float32)
            depth_img = self._image_on_device(depth).to(torch.float32)
            self._depth = depth_from_image(ff, depth_img, self.bf, self.max_depth)
            return self._track_with_depth(ff, ts)
