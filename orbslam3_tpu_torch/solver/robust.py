"""Robust kernels and chi2 gates shared by the optimizers.

Counterpart of `orbslam3_tpu/solver/robust.py`; constants mirror the
reference (src/Optimizer.cc).
"""

from __future__ import annotations

import torch

CHI2_MONO = 5.991      # 2-dof 95%
CHI2_STEREO = 7.815    # 3-dof 95%
CHI2_INERTIAL = 16.92  # 9-dof
HUBER_MONO = CHI2_MONO ** 0.5
HUBER_STEREO = CHI2_STEREO ** 0.5
HUBER_INERTIAL = CHI2_INERTIAL ** 0.5


def huber_weight(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber kernel given chi2 = r^T Omega r:
    1 for |r|_O <= delta, else delta / |r|_O (g2o RobustKernelHuber)."""
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= delta, 1.0, delta / e)
