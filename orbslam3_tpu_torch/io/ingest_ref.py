"""The plain version of the native ingest's stages (`csrc/ingest.cpp`):
bilinear remap -> resize (cv::resize INTER_LINEAR) -> CLAHE, in numpy.

The remap is `euroc.apply_undistort`; the resize and the CLAHE are the
oracles of the JAX package's IO tests (tests/test_io.py `_resize_np`,
`_clahe_np`), in float64.  The C++ runs in float32, so the two agree
within those tests' tolerances, not bit for bit: a CLAHE input within
float32 rounding of a bin edge (x.5) can fall in the next bin, which moves
that pixel by one step of its tile's LUT.  Used by the tests and
`chip_smoke.py` to hold the C++ to; the port's runtime path does not call
it.
"""

from __future__ import annotations

import numpy as np

from .euroc import apply_undistort


def resize(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv::resize INTER_LINEAR: src = (dst + 0.5) * scale - 0.5, clamped to
    the last pixel less 0.001 like the C++."""
    h, w = src.shape
    sy, sx = h / oh, w / ow
    ys = np.clip((np.arange(oh) + 0.5) * sy - 0.5, 0, h - 1.001)
    xs = np.clip((np.arange(ow) + 0.5) * sx - 0.5, 0, w - 1.001)
    y0 = ys.astype(np.int32)
    x0 = xs.astype(np.int32)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = src[np.ix_(y0, x0)]
    b = src[np.ix_(y0, x0 + 1)]
    c = src[np.ix_(y0 + 1, x0)]
    d = src[np.ix_(y0 + 1, x0 + 1)]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def clahe(src: np.ndarray, clip: float, grid: int) -> np.ndarray:
    """cv::createCLAHE(clip, (grid, grid)): per-tile clipped 256-bin
    histograms of the reflect-101 padded image, their CDFs as LUTs,
    bilinear between the four surrounding tiles."""
    h, w = src.shape
    th, tw = -(-h // grid), -(-w // grid)
    area = th * tw
    lut = np.zeros((grid, grid, 256))
    # round-half-up, like the C++ (int)(v + 0.5) — np.rint is half-to-even
    q = np.clip(np.floor(src + 0.5), 0, 255).astype(np.int32)
    # reflect-101 padded tile histograms
    yy = np.arange(grid * th)
    yy = np.where(yy < h, yy, 2 * (h - 1) - yy)
    xx = np.arange(grid * tw)
    xx = np.where(xx < w, xx, 2 * (w - 1) - xx)
    qp = q[np.ix_(yy, xx)]
    climit = max(1, int(clip * area / 256.0))
    for ty in range(grid):
        for tx in range(grid):
            tile = qp[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
            hist = np.bincount(tile.ravel(), minlength=256)
            excess = int(np.sum(np.maximum(hist - climit, 0)))
            hist = np.minimum(hist, climit)
            hist += excess // 256
            hist[: excess % 256] += 1
            lut[ty, tx] = 255.0 / area * np.cumsum(hist)
    gy = np.clip((np.arange(h) + 0.5) / th - 0.5, 0, None)
    ty0 = np.minimum(gy.astype(np.int32), grid - 2)
    fy = np.clip(gy - ty0, 0, 1)[:, None]
    gx = np.clip((np.arange(w) + 0.5) / tw - 0.5, 0, None)
    tx0 = np.minimum(gx.astype(np.int32), grid - 2)
    fx = np.clip(gx - tx0, 0, 1)[None, :]
    TY = ty0[:, None] + np.zeros_like(tx0)[None, :]
    TX = tx0[None, :] + np.zeros_like(ty0)[:, None]
    l00 = lut[TY, TX, q]
    l01 = lut[TY, TX + 1, q]
    l10 = lut[TY + 1, TX, q]
    l11 = lut[TY + 1, TX + 1, q]
    return (l00 * (1 - fx) + l01 * fx) * (1 - fy) + \
        (l10 * (1 - fx) + l11 * fx) * fy


def pipeline(img: np.ndarray, remap: np.ndarray | None = None,
             resize_hw: tuple[int, int] | None = None, clahe_clip: float = 0.0,
             clahe_grid: int = 8) -> np.ndarray:
    """One decoded gray frame through `NativeIngest`'s stages: the remap
    (shape (rh, rw, 2) source coords), the resize to `resize_hw` where it
    differs, CLAHE where clahe_clip > 0.  Returns float32."""
    cur = np.asarray(img, np.float32)
    if remap is not None:
        cur = apply_undistort(cur, remap)
    if resize_hw is not None and tuple(resize_hw) != cur.shape:
        cur = resize(cur, *resize_hw)
    if clahe_clip > 0:
        cur = clahe(cur, clahe_clip, clahe_grid)
    return np.asarray(cur, np.float32)


def clahe_gaps(got: np.ndarray, img: np.ndarray, remap: np.ndarray | None = None,
               resize_hw: tuple[int, int] | None = None, clahe_clip: float = 3.0,
               clahe_grid: int = 8, edge: float = 1e-3) -> dict:
    """How far a frame the C++ gave with CLAHE on (`got`) lies from
    `pipeline` on its decoded frame `img`: the largest and the mean
    difference, and the largest away from the bin edges, the pixels whose
    value before CLAHE lies within `edge` of x.5 (where float32 and float64
    may round into neighbouring bins)."""
    pre = pipeline(img, remap, resize_hw)
    d = np.abs(got - np.asarray(clahe(pre, clahe_clip, clahe_grid), np.float32))
    on_edge = np.abs(pre % 1.0 - 0.5) < edge
    return dict(max=float(d.max()), mean=float(d.mean()),
                max_off_edge=float(d[~on_edge].max()), n_edge=int(on_edge.sum()))
