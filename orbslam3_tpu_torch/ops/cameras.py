"""Camera models: pinhole and Kannala-Brandt-8 (fisheye), and the model
dispatch.

Counterpart of `orbslam3_tpu/ops/cameras.py` (reference
src/CameraModels/Pinhole.cpp, src/CameraModels/KannalaBrandt8.cpp).  Cameras
are plain parameter vectors (pinhole: [fx, fy, cx, cy]; KB8: [fx, fy, cx, cy,
k1, k2, k3, k4]); points are in the camera frame with z forward.  `project`
maps a camera-frame point to a pixel, `unproject` a pixel to a ray with z = 1
(pinhole) or to the KB8 bearing scaled to z = 1.  The model is a Python
string: one code path per model.
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


def unit_pinhole(device) -> torch.Tensor:
    """[1, 1, 0, 0]: the virtual pinhole on which KB8 bearings (scaled to
    z = 1) are handled as pixels; filled on the device (a tensor from a host
    list would be a blocking copy)."""
    return torch.cat([torch.ones(2, device=device), torch.zeros(2, device=device)])


# Kannala-Brandt 8: r(theta) = theta + k1 theta^3 + k2 theta^5 + k3 theta^7
# + k4 theta^9 (reference KannalaBrandt8.cpp:176 project, :216 unproject)

def _kb8_rtheta(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def _kb8_drtheta(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    t2 = theta * theta
    return 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))


def kb8_project(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point (..., 3) -> pixel (..., 2); an on-axis point
    (r < 1e-9) lands on the principal point."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r2d = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r2d, z)
    rt = _kb8_rtheta(k, theta)
    scale = rt / torch.where(r2d < _EPS, _EPS, r2d)
    scale = torch.where(r2d < _EPS, 0.0, scale)
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pixel (..., 2) -> bearing scaled to z = 1, (..., 3): a fixed `iters`
    Newton steps on r(theta) = r_d, as the JAX package runs them (the
    reference stops early at 1e-6; a fixed count keeps the host out of the
    loop and lands on the same fixed point)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    rd = torch.sqrt(mx * mx + my * my)
    rd_c = torch.clamp(rd, 0.0, torch.pi)     # the reference clips theta_d to [-pi, pi]
    theta = rd_c
    for _ in range(iters):
        f = _kb8_rtheta(k, theta) - rd_c
        df = _kb8_drtheta(k, theta)
        theta = theta - f / torch.where(torch.abs(df) < _EPS, _EPS, df)
    scale = torch.where(rd < _EPS, 1.0, torch.tan(theta) / torch.where(rd < _EPS, 1.0, rd))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(xc): (..., 2, 3), the derivative of `kb8_project`'s closed
    form (the JAX package takes it by forward-mode AD; the reference writes
    it out, KannalaBrandt8::projectJac).  Zero on the axis (r < 1e-9), where
    `kb8_project`'s scale is the constant 0."""
    fx, fy = params[0], params[1]
    k = params[4:8]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    on_axis = r < _EPS
    r_s = torch.where(on_axis, _EPS, r)
    theta = torch.atan2(r, z)
    rt = _kb8_rtheta(k, theta)
    drt = _kb8_drtheta(k, theta)
    rho2 = torch.where(on_axis, 1.0, r2 + z * z)
    s = rt / r_s
    # s(theta(x, y, z), r(x, y)): ds = drt / r dtheta - rt / r^2 dr
    ds_dth = drt / r_s
    ds_dr = -rt / (r_s * r_s)
    dth_dx = z * x / (r_s * rho2)
    dth_dy = z * y / (r_s * rho2)
    dth_dz = -r / rho2
    ds_dx = ds_dth * dth_dx + ds_dr * x / r_s
    ds_dy = ds_dth * dth_dy + ds_dr * y / r_s
    ds_dz = ds_dth * dth_dz
    row0 = torch.stack([fx * (s + x * ds_dx), fx * x * ds_dy, fx * x * ds_dz], dim=-1)
    row1 = torch.stack([fy * y * ds_dx, fy * (s + y * ds_dy), fy * y * ds_dz], dim=-1)
    J = torch.stack([row0, row1], dim=-2)
    return torch.where(on_axis[..., None, None], 0.0, J)


def project(model: str, params, xc):
    if model == PINHOLE:
        return pinhole_project(params, xc)
    if model == KANNALA_BRANDT8:
        return kb8_project(params, xc)
    raise ValueError(f"unknown camera model {model}")


def unproject(model: str, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    if model == KANNALA_BRANDT8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera model {model}")


def project_jac(model: str, params, xc):
    if model == PINHOLE:
        return pinhole_project_jac(params, xc)
    if model == KANNALA_BRANDT8:
        return kb8_project_jac(params, xc)
    raise ValueError(f"unknown camera model {model}")
