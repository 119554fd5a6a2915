"""FAST-9 corner detection as a whole-image stencil.

Counterpart of `orbslam3_tpu/ops/fast.py`:

  * corner test: >= 9 contiguous pixels of the 16-pixel Bresenham circle
    (radius 3) all brighter than center+th or all darker than center-th;
  * score: the largest threshold at which the pixel is still a corner,
    in closed form (max over the 16 length-9 arcs of the arc-min
    brightness excess, minus one);
  * NMS: strict 3x3 local max, ties broken toward the lexicographically
    first pixel.

The 16 taps are `torch.roll`s of the image (wrap-around, masked by the
border afterwards, as in the JAX version).
"""

from __future__ import annotations

import torch

# Bresenham circle radius 3, clockwise from 12 o'clock (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score(img: torch.Tensor, border: int = 3) -> torch.Tensor:
    """Per-pixel FAST-9 corner score; 0 where not a corner at th=1.

    img: (H, W) f32.  Returns (H, W) f32 score (integer-valued on integer
    images).  A pixel is a corner at threshold `th` iff score >= th.
    """
    c = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1))
                     for (dy, dx) in CIRCLE], dim=0)   # (16, H, W)
    d_bright = c - img[None]
    d_dark = img[None] - c

    def max_min9(d):
        # min over 9 contiguous entries starting at each of the 16 positions
        m1 = torch.minimum(d, torch.roll(d, -1, dims=0))
        m2 = torch.minimum(m1, torch.roll(m1, -2, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -4, dims=0))
        w9 = torch.minimum(m4, torch.roll(d, -8, dims=0))
        return torch.amax(w9, dim=0)

    score = torch.maximum(max_min9(d_bright), max_min9(d_dark)) - 1.0
    score = torch.clamp_min(score, 0.0)

    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    b = max(border, 3)
    valid = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    return torch.where(valid, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression; returns score where local max else 0.

    Strict '>' against the 4 lexicographically-earlier neighbours and '>='
    against the later 4: a deterministic single winner for plateaus of 2.
    """
    s = score
    earlier = [(-1, -1), (-1, 0), (-1, 1), (0, -1)]
    later = [(0, 1), (1, -1), (1, 0), (1, 1)]
    keep = s > 0
    for dy, dx in earlier:
        keep &= s > torch.roll(s, (-dy, -dx), dims=(0, 1))
    for dy, dx in later:
        keep &= s >= torch.roll(s, (-dy, -dx), dims=(0, 1))
    return torch.where(keep, s, torch.zeros_like(s))


def detect(img: torch.Tensor, threshold: float, border: int = 3) -> torch.Tensor:
    """Score map after threshold + NMS (0 = no corner)."""
    s = fast_score(img, border)
    s = torch.where(s >= threshold, s, torch.zeros_like(s))
    return nms3x3(s)
