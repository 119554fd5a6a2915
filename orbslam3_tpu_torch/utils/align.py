"""Trajectory alignment on the host: Umeyama Sim(3) and the ATE RMSE.

NumPy only.  The port's own copy of what `umeyama_alignment` and `ate_rmse`
of `orbslam3_tpu/ops/align.py` compute (reference
evaluation/evaluate_ate_scale.py:50-80): a monocular trajectory has a free
scale, so every trajectory gate aligns with scale first.  Computed in
float64.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src, dst, with_scale: bool = True):
    """Least-squares similarity dst ~= s * R @ src + t for (N, 3) point
    sets (Umeyama 1991).  Returns (R, t, s)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    R = U @ S @ Vt
    var_s = np.mean(np.sum(xs * xs, axis=1))
    s = float(np.sum(D * np.diag(S)) / (var_s + 1e-12)) if with_scale else 1.0
    return R, mu_d - s * R @ mu_s, s


def ate_rmse(est, gt, with_scale: bool = True):
    """Absolute trajectory error of associated positions est, gt (N, 3)
    after alignment.  Returns (rmse, s, R, t)."""
    R, t, s = umeyama_alignment(est, gt, with_scale=with_scale)
    err = s * np.asarray(est, np.float64) @ R.T + t - np.asarray(gt, np.float64)
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1)))), s, R, t
