"""Lie-group operations on SO(3), SE(3) and Sim(3), the part the port calls.

Counterpart of `orbslam3_tpu/ops/lie.py`.  Rotations are 3x3 float32
matrices; every function broadcasts over leading batch dimensions.  SE(3)
is a pair (R, t) with the reference's convention: T_cw maps world to
camera, x_c = R x_w + t; Sim(3) a triple (R, t, s) with x' = s R x + t.
Matrix products run in full float32 (the package's precision policy), as
the JAX code pins Precision.HIGHEST.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """einsum('...ij,...j->...i')."""
    return torch.einsum("...ij,...j->...i", A, x)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sin_x_over_x(x2: torch.Tensor) -> torch.Tensor:
    """sin(x)/x with Taylor fallback, given x^2."""
    x = torch.sqrt(x2 + _EPS * (x2 < _EPS))
    return torch.where(x2 < 1e-8, 1.0 - x2 / 6.0, torch.sin(x) / x)


def _one_minus_cos_over_x2(x2: torch.Tensor) -> torch.Tensor:
    """(1-cos x)/x^2 with Taylor fallback, given x^2."""
    x = torch.sqrt(x2 + _EPS * (x2 < _EPS))
    return torch.where(x2 < 1e-8, 0.5 - x2 / 24.0,
                       (1.0 - torch.cos(x)) / (x2 + _EPS))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: so(3) vector (..., 3) -> rotation matrix (..., 3, 3)."""
    x2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = hat(w)
    return _eye_like(W) + _sin_x_over_x(x2) * W + \
        _one_minus_cos_over_x2(x2) * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> so(3) vector (..., 3).

    Trace formula with a fallback near pi.  The angle comes from
    atan2(|w_unnorm|, cos) with the double-where guard at zero rotation
    (lie.py:68): arccos has an infinite derivative at +-1, and keeping the
    same form keeps the same numbers (and finite gradients later).  The
    scalars per rotation keep a trailing dimension of 1: under
    `torch.func.jacfwd`, torch 2.13 gives a 0-d float32 tensor combined with
    a Python float a float64 tangent.
    """
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_unnorm = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    s2 = torch.sum(w_unnorm * w_unnorm, dim=-1, keepdim=True)
    small = s2 < 1e-10
    s2_safe = torch.where(small, torch.ones_like(s2), s2)
    sin_t = torch.sqrt(s2_safe)
    theta = torch.atan2(sin_t, cos_t)
    near_pi = cos_t < math.cos(math.pi - 1e-3)
    scale = torch.where(small, torch.ones_like(theta), theta / sin_t)
    w_generic = w_unnorm * scale
    theta_pi = math.pi - torch.asin(
        torch.clamp(torch.sqrt(s2 + 1e-20), 0.0, 1.0 - 1e-7))
    B = R + _eye_like(R)
    d = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(d, dim=-1)
    col = torch.gather(B, -1, k[..., None, None].expand(B.shape[:-1] + (1,)))[..., 0]
    axis = col / (torch.linalg.norm(col, dim=-1, keepdim=True) + _EPS)
    sgn = torch.where(torch.sum(axis * w_unnorm, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = axis * sgn * theta_pi
    return torch.where(near_pi, w_pi, w_generic)


def right_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) of SO(3): d Exp(w+dw) = Exp(w) Exp(Jr dw)."""
    x2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = hat(w)
    x = torch.sqrt(x2 + _EPS * (x2 < _EPS))
    small = x2 < 1e-8
    c1 = torch.where(small, 0.5 - x2 / 24.0, (1.0 - torch.cos(x)) / (x2 + _EPS))
    c2 = torch.where(small, 1.0 / 6.0 - x2 / 120.0,
                     (x - torch.sin(x)) / (x2 * x + _EPS))
    return _eye_like(W) - c1 * W + c2 * (W @ W)


def left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian Jl(w) = Jr(-w)."""
    return right_jacobian_so3(-w)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a near-rotation matrix with two Newton-Schulz
    polar steps (R <- 1.5 R - 0.5 R R^T R), as the JAX package does."""
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = 1.5 * R - 0.5 * (R @ RtR)
    return R


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactor expansion: a few
    elementwise kernels, no factorization and no status read."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def normalize_rotation_svd(R: torch.Tensor) -> torch.Tensor:
    """Exact projection onto SO(3) through the SVD: handles arbitrary
    (possibly reflected or scaled) inputs, such as a raw linear pose
    estimate, which the Newton-Schulz steps of `normalize_rotation` do not."""
    U, _, Vh = torch.linalg.svd(R)
    sign = torch.sign(det3(U @ Vh))
    D = torch.ones_like(R[..., 0])
    D = torch.cat([D[..., :2], sign[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vh


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd conversion by selects, (..., 3, 3) -> (..., 4) wxyz; the
    largest of the four pivots is taken, the first on ties."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1),
    ], dim=-2)                                        # (..., 4 candidates, 4)
    idx = torch.argmax(torch.diagonal(qs, dim1=-2, dim2=-1), dim=-1)
    q = torch.gather(qs, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)


def se3_exp(xi: torch.Tensor):
    """se(3) -> SE(3).  xi = [rho (trans), phi (rot)], shape (..., 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return exp_so3(phi), _mv(left_jacobian_so3(phi), rho)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb): applies b first, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_apply(R, t, x):
    return _mv(R, x) + t


# Sim(3): (R, t, s) with x' = s R x + t (loop closure).

def sim3_apply(R, t, s, x):
    return s[..., None] * _mv(R, x) + t


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) o (Rb, tb, sb): applies b first, then a."""
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb
