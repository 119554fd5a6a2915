"""IC-angle (intensity centroid) keypoint orientation.

Counterpart of `orbslam3_tpu/ops/orient.py`: moments m10 = sum(u * I),
m01 = sum(v * I) over a circular patch of radius HALF_PATCH_SIZE=15 whose
per-row half-width is the `umax` table; angle = atan2(m01, m10) in
degrees [0, 360).

`ic_moments` is the plain twin of the CUDA kernel `ic_moments`
(`ops/orb_patches.py`, `csrc/orb_patches.cu`): it gathers the (N, 31, 31)
windows and contracts them with the two weight images.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

HALF_PATCH_SIZE = 15


@functools.lru_cache(maxsize=None)
def _umax_table(half_patch: int = HALF_PATCH_SIZE) -> np.ndarray:
    """Per-row half-width of the circular patch, symmetric like the
    reference (src/ORBextractor.cc:128-144)."""
    umax = np.zeros(half_patch + 2, dtype=np.int32)
    vmax = int(np.floor(half_patch * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half_patch * np.sqrt(2.0) / 2))
    hp2 = half_patch * half_patch
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half_patch + 1]


@functools.lru_cache(maxsize=None)
def _moment_weights(half_patch: int = HALF_PATCH_SIZE):
    """(2r+1, 2r+1) weight images (wu, wv) implementing the circular mask:
    wu[y, x] = u if |u| <= umax[|v|] else 0, and likewise wv."""
    r = half_patch
    umax = _umax_table(half_patch)
    u = np.arange(-r, r + 1)
    uu, vv = np.meshgrid(u, u)  # vv rows, uu cols
    inside = np.abs(uu) <= umax[np.abs(vv)]
    wu = (uu * inside).astype(np.float32)
    wv = (vv * inside).astype(np.float32)
    return wu, wv


def extract_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """Gather (2r+1)^2 patches at integer xy (N, 2) -> (N, s, s).  Window
    starts are clamped so patches stay in-bounds."""
    h, w = img.shape
    s = 2 * radius + 1
    x0 = torch.clamp(xy[:, 0] - radius, 0, w - s).long()
    y0 = torch.clamp(xy[:, 1] - radius, 0, h - s).long()
    ar = torch.arange(s, device=img.device)
    rows = (y0[:, None] + ar[None, :])[:, :, None]
    cols = (x0[:, None] + ar[None, :])[:, None, :]
    return img[rows, cols]


@functools.lru_cache(maxsize=None)
def _weights_on(half_patch: int, device: str) -> torch.Tensor:
    """(s, s, 2) [wu, wv] on `device`."""
    wu, wv = _moment_weights(half_patch)
    return torch.from_numpy(np.stack([wu, wv], axis=-1)).to(device)


def ic_moments(img: torch.Tensor, xy: torch.Tensor,
               half_patch: int = HALF_PATCH_SIZE) -> torch.Tensor:
    """(N, 2) moments [m10, m01] of the windows at floor(xy) - half_patch
    (clamped), the quantity the Pallas kernel reduces in VMEM."""
    patches = extract_patches(img, xy.to(torch.int32), half_patch)
    return torch.einsum("nij,ijc->nc", patches,
                        _weights_on(half_patch, str(img.device)))


def angle_from_moments(mom: torch.Tensor) -> torch.Tensor:
    """(N, 2) [m10, m01] -> degrees in [0, 360)."""
    ang = torch.atan2(mom[:, 1], mom[:, 0])
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang)
    return ang * (180.0 / math.pi)


def ic_angle_conv(img: torch.Tensor, xy: torch.Tensor,
                  half_patch: int = HALF_PATCH_SIZE) -> torch.Tensor:
    """Dense-moment-map variant: one 2-channel (2r+1)^2 correlation of the
    whole image, read at the keypoints' integer coordinates (clamped)."""
    k = _weights_on(half_patch, str(img.device)).permute(2, 0, 1)[:, None]   # (2, 1, s, s)
    m = torch.nn.functional.conv2d(img[None, None], k, padding=half_patch)[0]
    xi = torch.clamp(xy[:, 0].to(torch.int32), 0, img.shape[1] - 1).long()
    yi = torch.clamp(xy[:, 1].to(torch.int32), 0, img.shape[0] - 1).long()
    return angle_from_moments(m[:, yi, xi].T)


def ic_angle(img: torch.Tensor, xy: torch.Tensor,
             half_patch: int = HALF_PATCH_SIZE) -> torch.Tensor:
    """Orientation in degrees [0, 360) for integer keypoint coords (N, 2)."""
    return angle_from_moments(ic_moments(img, xy, half_patch))
