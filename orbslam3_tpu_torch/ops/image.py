"""Image ops for the ORB front-end: pyramid resize + Gaussian blur.

Counterpart of `orbslam3_tpu/ops/image.py`.  Level L of the pyramid is a
linear resize of level L-1 by 1/scale_factor; every level also gets a
5x5 Gaussian (sigma 1.2, reflect-101 border) rounded to integers, used
only for descriptor sampling.

The resize reproduces `jax.image.resize(method="linear")`, which
antialiases when it downscales: the triangle kernel is widened by the
downscale factor and every output sample is normalised by its weight sum.
`F.interpolate(antialias=True)` differs from it by up to ~2e-3, enough to
flip FAST and NMS decisions on levels 1-7, so the resize is built the way
JAX builds it: two dense weight matrices (float32 arithmetic in the same
order as `jax._src.image.scale.compute_weight_mat`) applied as
`Ry @ img @ Rx^T`.  The blur is the same banded-matrix formulation as the
JAX package, with reflect-101 folded into the band.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Static per-level (h, w), matching cvRound(dim * invScale^L)."""
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (scale_factor ** lv)
        shapes.append((int(np.rint(h * s)), int(np.rint(w * s))))
    return shapes


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 linear-resize operator, antialiased when
    downscaling, as `jax.image.resize(method="linear")` computes it."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one multiply-add (one
    # rounding); the float64 product of two float32 values is exact, so
    # rounding once to float32 reproduces it.  Unfused, 1-ulp shifts of the
    # sample positions move weights by up to 2e-5.
    centers = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (centers * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
        weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T.astype(f32))


@functools.lru_cache(maxsize=None)
def _gauss_kernel_np(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_band_np(n: int, ksize: int, sigma: float) -> np.ndarray:
    """(n, n) banded 1-D Gaussian operator with BORDER_REFLECT_101 folded
    into the boundary rows: out = B @ x."""
    k = _gauss_kernel_np(ksize, sigma).astype(np.float64)
    r = ksize // 2
    B = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(-r, r + 1):
            j = i + t
            if j < 0:
                j = -j          # reflect-101: -1 -> 1
            elif j >= n:
                j = 2 * (n - 1) - j
            B[i, j] += k[t + r]
    return B.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, args: tuple, device: str) -> torch.Tensor:
    """Operator matrices, built once per shape and device (a per-frame
    host-to-device copy of a 752x752 band would cost more than the blur)."""
    mat = _resize_matrix_np(*args) if kind == "resize" else _blur_band_np(*args)
    return torch.from_numpy(mat).to(device)


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    h, w = img.shape
    dev = str(img.device)
    Ry = _on_device("resize", (h, out_hw[0]), dev)
    Rx = _on_device("resize", (w, out_hw[1]), dev)
    return Ry @ (img @ Rx.T)


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 1.2) -> torch.Tensor:
    """Separable Gaussian with reflect-101 border, as out = Bv @ img @ Bh^T
    in full float32 (see the package's precision policy)."""
    h, w = img.shape
    dev = str(img.device)
    Bv = _on_device("blur", (h, ksize, sigma), dev)
    Bh = _on_device("blur", (w, ksize, sigma), dev)
    return Bv @ (img @ Bh.T)


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """Returns (pyramid, blurred_pyramid): lists of per-level images.  The
    blurred levels are rounded to integers (half to even), matching the
    reference's uint8 blurred image and `orbslam3_tpu/ops/image.py:98`."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    pyr = [img]
    for lv in range(1, n_levels):
        pyr.append(resize_bilinear(pyr[-1], shapes[lv]))
    blurred = [torch.round(gaussian_blur(p)) for p in pyr]
    return pyr, blurred
