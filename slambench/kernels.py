"""The card's peaks and the work of the program's hand-written kernels.

`orb_describe` (one launch per `extract`) reads, for every keypoint slot,
the 31x31 circular IC-angle window of the raw pyramid atlas and the rBRIEF
samples of the blurred atlas in the keypoint's angle bin, and writes the
angle and the 256-bit descriptor.  Its least traffic counts each distinct
atlas pixel it needs once (float32), the keypoints (8 bytes each), the umax
table, one bin table per bin in use (256 char4 pairs), and its outputs
(4 + 32 bytes a keypoint); its operations (2 multiply-adds per moment-window
pixel, one compare per bit) take a twentieth of that time at the 67 TFLOP/s
float32 peak, so bytes bound it.
"""

from __future__ import annotations

import numpy as np

from . import reference as ref

# NVIDIA H100 SXM (data sheet): HBM3 bandwidth at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12


def atlas_coords(xy: np.ndarray, octave: np.ndarray, hw, n_levels: int, scale_factor: float):
    """Level-0 keypoint coordinates -> integer coordinates in the atlas that
    stacks the pyramid's levels vertically; also the atlas's (h, w)."""
    shapes = ref.pyramid_shapes(hw, n_levels, scale_factor)
    row_off = np.cumsum([0] + [s[0] for s in shapes[:-1]])
    sf = scale_factor ** octave.astype(np.float64)
    k = np.rint(xy / sf[:, None]).astype(np.int64)
    k[:, 1] += row_off[octave]
    return k, (int(sum(s[0] for s in shapes)), int(shapes[0][1]))


def orb_describe_bytes(xy_atlas: np.ndarray, angle_deg: np.ndarray, atlas_hw) -> int:
    """The bytes one `orb_describe` launch needs for keypoints at integer
    atlas coordinates `xy_atlas` (n, 2) with angles `angle_deg`."""
    h, w = atlas_hw
    n = xy_atlas.shape[0]
    r = ref.HALF_PATCH
    u = np.arange(-r, r + 1)
    dy, dx = np.nonzero(np.abs(u)[None, :] <= ref.umax()[np.abs(u)][:, None])
    x0 = np.clip(xy_atlas[:, 0] - r, 0, w - (2 * r + 1))
    y0 = np.clip(xy_atlas[:, 1] - r, 0, h - (2 * r + 1))
    mom = np.unique(((y0[:, None] + dy) * w + x0[:, None] + dx).ravel()).size
    R = ref.BRIEF_R
    bins = ref.angle_bins(angle_deg)
    off = ref.binned_offsets()[bins]
    bx0 = np.clip(xy_atlas[:, 0] - R, 0, w - (2 * R + 1))
    by0 = np.clip(xy_atlas[:, 1] - R, 0, h - (2 * R + 1))
    brf = np.unique(((by0[:, None] + R + off[..., 1]) * w + bx0[:, None] + R + off[..., 0]).ravel()).size
    table = np.unique(bins).size * 256 * 4
    return int(4 * (mom + brf) + 8 * n + 4 * (r + 1) + table + 4 * n + 32 * n)
