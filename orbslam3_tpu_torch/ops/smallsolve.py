"""Unrolled small SPD solve.

Counterpart of `orbslam3_tpu/ops/smallsolve.solve_psd`.  The Cholesky is
unrolled over scalars exactly as in the JAX package, rather than handed to
`torch.linalg.solve`, so that the pose optimizer takes the same
arithmetic steps and lands on the same numbers.
"""

from __future__ import annotations

import torch


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A of static size n (n <= ~16) with an
    unrolled Cholesky (no pivoting; callers damp A).

    A: (..., n, n); b: (..., n).
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
