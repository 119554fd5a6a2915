"""Rotated BRIEF (rBRIEF) 256-bit descriptors, binned orientation.

Counterpart of `orbslam3_tpu/ops/brief.py`.  For each of 256 point pairs
(p, q) of the learned ORB pattern (`orbslam3_tpu/data/orb_pattern.npy`,
read by its path), sample the blurred, integer-rounded image at the
pattern points rotated to the keypoint's angle bin, and set bit k iff
I(p) < I(q).  Word w bit b holds pair 32w+b.

Descriptors are (N, 8) int32 tensors holding the uint32 bit patterns:
torch on the CPU has no `>>` for uint32, and int32 bit patterns unpack
with an arithmetic shift and a mask just as well.

`compute_descriptors` is the plain twin of the CUDA kernel `brief_desc`
(`ops/orb_patches.py`).  It samples the 512 points directly; the JAX
package's one-hot matmul stack over the (N, 1521) patches gives the same
values (it selects exact integers) and exists only for the TPU's MXU.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import DATA_DIR

_PATTERN_PATH = os.path.join(DATA_DIR, "orb_pattern.npy")

N_ANGLE_BINS = 32  # 11.25 deg granularity
_PATCH_R = 19      # max |rotated pattern point| = ceil(13 * sqrt(2))


@functools.lru_cache(maxsize=None)
def pattern() -> np.ndarray:
    """(512, 2) int32 pattern points (x, y); pairs are (2k, 2k+1)."""
    return np.load(_PATTERN_PATH)


@functools.lru_cache(maxsize=None)
def _binned_offsets(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    """(n_bins, 512, 2) integer pattern offsets (x, y) rotated to each bin
    center (round half to even, like __float2int_rn)."""
    pat = pattern().astype(np.float64)
    out = np.zeros((n_bins, 512, 2), np.int32)
    for b in range(n_bins):
        a = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(a), np.sin(a)
        out[b, :, 0] = np.rint(pat[:, 0] * ca - pat[:, 1] * sa)
        out[b, :, 1] = np.rint(pat[:, 0] * sa + pat[:, 1] * ca)
    return out


@functools.lru_cache(maxsize=None)
def _offsets_on(device: str) -> torch.Tensor:
    return torch.from_numpy(_binned_offsets()).long().to(device)


def angle_bins(angle_deg: torch.Tensor, n_bins: int = N_ANGLE_BINS) -> torch.Tensor:
    """round(angle * n_bins / 360) mod n_bins (brief.py:72), int64."""
    return torch.remainder(torch.round(angle_deg * (n_bins / 360.0)).long(), n_bins)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 bit patterns, word w bit b = 32w+b."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(bits.reshape(-1, 8, 32).long() << shifts, dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def compute_descriptors(img_blurred: torch.Tensor, xy: torch.Tensor,
                        angle_deg: torch.Tensor) -> torch.Tensor:
    """Descriptors for N keypoints (discrete-orientation formulation):
    the window starts at round(xy) - 19, clamped into the image, and every
    sample sits at (y0 + 19 + oy, x0 + 19 + ox).  Returns (N, 8) int32."""
    h, w = img_blurred.shape
    S = 2 * _PATCH_R + 1
    x0 = torch.clamp(torch.round(xy[:, 0]).long() - _PATCH_R, 0, w - S)
    y0 = torch.clamp(torch.round(xy[:, 1]).long() - _PATCH_R, 0, h - S)
    off = _offsets_on(str(img_blurred.device))[angle_bins(angle_deg)]  # (N,512,2)
    ys = y0[:, None] + _PATCH_R + off[..., 1]
    xs = x0[:, None] + _PATCH_R + off[..., 0]
    vals = img_blurred[ys, xs]                      # (N, 512)
    return pack_bits(vals[:, 0::2] < vals[:, 1::2])


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 bit patterns -> (N, 256) float {0,1}."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    b = (desc[:, :, None] >> shifts[None, None, :]) & 1
    return b.reshape(desc.shape[0], 256).to(torch.float32)


def hamming_distance(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance (Na, 8)x(Nb, 8) -> (Na, Nb) int32, as
    |a| + |b| - 2 a.b over the unpacked bit vectors (exact in float32:
    every partial sum is an integer <= 256)."""
    A = unpack_bits(desc_a)
    B = unpack_bits(desc_b)
    na = torch.sum(A, dim=1, keepdim=True)
    nb = torch.sum(B, dim=1, keepdim=True)
    dot = A @ B.T
    return (na + nb.T - 2.0 * dot).to(torch.int32)


def compute_descriptors_exact(img_blurred: torch.Tensor, xy: torch.Tensor,
                              angle_deg: torch.Tensor) -> torch.Tensor:
    """Continuous-rotation formulation (one gather of 512 samples per
    keypoint; the reference CUDA kernel's rotation, Orb_gpu.cu
    calcOrb_kernel), the oracle of the binned rBRIEF above.  Every
    rotated pattern point is rounded half to even, like __float2int_rn,
    added to round(xy) and clamped into the image.  Returns (N, 8) int32."""
    h, w = img_blurred.shape
    dev = img_blurred.device
    pat = torch.from_numpy(pattern().astype(np.float32)).to(dev)   # (512, 2) x, y
    ang = angle_deg * (np.pi / 180.0)
    ca, sa = torch.cos(ang), torch.sin(ang)                         # (N,)
    px, py = pat[:, 0], pat[:, 1]
    rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    gx = torch.clamp(torch.round(xy[:, 0:1]) + rx, 0, w - 1).long()
    gy = torch.clamp(torch.round(xy[:, 1:2]) + ry, 0, h - 1).long()
    vals = img_blurred[gy, gx]                                      # (N, 512)
    return pack_bits(vals[:, 0::2] < vals[:, 1::2])
