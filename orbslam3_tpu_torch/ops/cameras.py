"""Camera models: the pinhole model and the model dispatch.

Counterpart of `orbslam3_tpu/ops/cameras.py`.  Cameras are plain parameter
vectors (pinhole: [fx, fy, cx, cy]); points are in the camera frame with
z forward.  The Kannala-Brandt-8 fisheye is not ported yet: the dispatch
raises for it.
"""

from __future__ import annotations

import torch

PINHOLE = "pinhole"
KANNALA_BRANDT8 = "kb8"

_EPS = 1e-9


def pinhole_project(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point (..., 3) -> pixel (..., 2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < _EPS, _EPS, z)
    u = fx * xc[..., 0] * inv_z + cx
    v = fy * xc[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) -> ray with z=1, shape (..., 3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(xc): (..., 2, 3)."""
    fx, fy = params[0], params[1]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z = torch.where(torch.abs(z) < _EPS, _EPS, z)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _unported(model: str):
    if model == KANNALA_BRANDT8:
        return NotImplementedError("the Kannala-Brandt-8 camera is not ported yet "
                                   "(ROADMAP queue 1 item 6)")
    return ValueError(f"unknown camera model {model}")


def project(model: str, params, xc):
    if model == PINHOLE:
        return pinhole_project(params, xc)
    raise _unported(model)


def unproject(model: str, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    raise _unported(model)


def project_jac(model: str, params, xc):
    if model == PINHOLE:
        return pinhole_project_jac(params, xc)
    raise _unported(model)
