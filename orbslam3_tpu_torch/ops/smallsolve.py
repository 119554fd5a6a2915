"""Unrolled small SPD solves.

Counterpart of `orbslam3_tpu/ops/smallsolve.py`: `solve_psd` (one small
system, the pose optimizer's) and `solve_psd_blocked` (the window BA's
reduced camera system, a block Cholesky over 6x6 blocks).  The Cholesky
is unrolled exactly as in the JAX package, rather than handed to
`torch.linalg.cholesky`, so that both packages take the same arithmetic
steps and land on the same numbers.
"""

from __future__ import annotations

import torch


def _chol_blocks(A):
    """Unrolled scalar Cholesky of (..., n, n) SPD A; returns the lower
    factor as a list-of-lists of (...,) scalars (n small, <= ~8)."""
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
    return L


def _tri_lower_inv(L, n):
    """Unrolled inverse of a lower-triangular factor given as scalar
    list-of-lists; returns a dense (..., n, n) tensor (upper part zero)."""
    zero = torch.zeros_like(L[0][0])
    one = torch.ones_like(L[0][0])
    M = [[None] * n for _ in range(n)]
    for c in range(n):
        for i in range(n):
            if i < c:
                M[i][c] = zero
            else:
                s = one if i == c else zero
                for k in range(c, i):
                    s = s - L[i][k] * M[k][c]
                M[i][c] = s / L[i][i]
    return torch.stack([torch.stack(M[i], dim=-1) for i in range(n)], dim=-2)


def solve_psd_blocked(A: torch.Tensor, b: torch.Tensor, bs: int = 6) -> torch.Tensor:
    """Solve A x = b for SPD (n, n) A with n = K*bs via a block Cholesky
    unrolled over the K block-columns (K static, <= ~32).  No pivoting:
    callers damp A."""
    n = A.shape[-1]
    assert n % bs == 0
    K = n // bs
    if K == 1:
        return solve_psd(A, b)
    Ab = A.reshape(K, bs, K, bs).permute(0, 2, 1, 3)   # (K, K, bs, bs)
    bb = b.reshape(K, bs)

    Lcols = []      # Lcols[j]: (K, bs, bs), column j of the factor
    Linv_diag = []  # inverse of each diagonal block's factor
    idx = torch.arange(K, device=A.device)
    for j in range(K):
        Linv = _tri_lower_inv(_chol_blocks(Ab[j, j]), bs)
        Linv_diag.append(Linv)
        # C_i = A[i, j] @ Linv^T for the strictly-below blocks i > j
        C = torch.einsum("iab,cb->iac", Ab[:, j], Linv)
        Cb = C * (idx > j).to(A.dtype)[:, None, None]
        Lcols.append(Cb)
        # trailing update A[i, i'] -= C_i C_i'^T (rows/cols <= j get zeros)
        Ab = Ab - torch.einsum("iab,jcb->ijac", Cb, Cb)

    # forward substitution: y_j = Linv_jj (b_j - sum_{k<j} L[j,k] y_k)
    y = [None] * K
    r = bb
    for j in range(K):
        y[j] = Linv_diag[j] @ r[j]
        r = r - torch.einsum("iab,b->ia", Lcols[j], y[j])
    # back substitution: x_j = Linv_jj^T (y_j - sum_{k>j} L[k,j]^T x_k)
    Lmat = torch.stack(Lcols, 1)    # (K rows, K cols, bs, bs)
    x = [None] * K
    acc = torch.zeros_like(bb)
    for j in reversed(range(K)):
        x[j] = Linv_diag[j].T @ (y[j] - acc[j])
        acc = acc + torch.einsum("pab,a->pb", Lmat[j], x[j])
    return torch.stack(x, 0).reshape(n)


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
