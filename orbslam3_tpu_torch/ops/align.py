"""Point-set alignment on the device: the Umeyama similarity transform,
Horn's rigid alignment and the ATE RMSE.

Counterpart of `orbslam3_tpu/ops/align.py` (Umeyama 1991; the Sim3 solver's
closed form, reference src/Sim3Solver.cc:311 ComputeSim3), batched over
leading dimensions so that one call fits every RANSAC hypothesis.
`eval/ate.py` aligns trajectories through it in float32, as the JAX
package does; `utils/align.py` is the float64 NumPy version that the
drives' gates use on the host.

The rotation is U S Vt with S = diag(1, 1, sign(det U det Vt)): a sign
choice of the SVD flips a column of U together with the matching row of
Vt, so R does not depend on it.  The determinants are cofactor expansions
(`lie.det3`), which read nothing back; `torch.linalg.svd` itself checks its
status on the host on a card.
"""

from __future__ import annotations

import torch

from . import lie


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True,
                      weights: torch.Tensor | None = None):
    """Least-squares similarity dst ~= s R src + t.

    src, dst: (..., N, 3); weights: optional (..., N) nonnegative.  Returns
    (R (..., 3, 3), t (..., 3), s (...))."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.sum(weights, dim=-1, keepdim=True) + 1e-12
    wn = (weights / wsum)[..., None]                               # (..., N, 1)
    mu_s = torch.sum(src * wn, dim=-2)
    mu_d = torch.sum(dst * wn, dim=-2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = (xd * wn).transpose(-1, -2) @ xs                         # (..., 3, 3)
    U, D, Vt = torch.linalg.svd(cov)
    sgn = torch.sign(lie.det3(U) * lie.det3(Vt))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * diag[..., None, :]) @ Vt
    if with_scale:
        var_s = torch.sum(wn[..., 0] * torch.sum(xs * xs, dim=-1), dim=-1)
        s = torch.sum(D * diag, dim=-1) / (var_s + 1e-12)
    else:
        s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * lie._mv(R, mu_s)
    return R, t, s


def horn_alignment(src: torch.Tensor, dst: torch.Tensor):
    """Rigid alignment (R, t) minimizing ||dst - (R src + t)|| (Horn, via
    the SVD of `umeyama_alignment` without scale)."""
    R, t, _ = umeyama_alignment(src, dst, with_scale=False)
    return R, t


def ate_rmse(est: torch.Tensor, gt: torch.Tensor, with_scale: bool = True):
    """Absolute trajectory error after Horn(+scale) alignment, in the
    tensors' own dtype (float32 for the JAX package's metric).

    est, gt: (N, 3) associated positions.  Returns (rmse, s, R, t): the
    reference acceptance oracle (evaluation/evaluate_ate_scale.py: align(),
    then the RMSE over the translational residuals)."""
    R, t, s = umeyama_alignment(est, gt, with_scale=with_scale)
    err = s * (est @ R.T) + t - gt
    rmse = torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))
    return rmse, s, R, t
