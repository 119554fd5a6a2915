"""Two-view monocular initialization: batched RANSAC of F (8-point) and H
(DLT), model selection, motion recovery and cheirality checks.

Counterpart of `orbslam3_tpu/geometry/twoview.py` (parity target: reference
src/TwoViewReconstruction.cc):
  * 200 RANSAC iterations over 8-point samples for both models;
  * normalization by mean absolute deviation;
  * scoring: symmetric transfer chi2; F: th=3.841, score term 5.991-chi2;
    H: th=5.991 both directions;
  * selection: RH = SH/(SH+SF) > 0.40 -> H else F;
  * ReconstructF: E = K^T F K, 4 motions, CheckRT with reprojection
    threshold 4*sigma2, cheirality cosParallax<0.99998, the winner needs
    maxGood >= max(0.9N, 50), no second hypothesis > 0.7*maxGood and
    parallax > 1 degree;
  * ReconstructH: Faugeras 8-motion decomposition, the winner needs
    secondBest < 0.75*best, parallax >= 1, best > 50 and > 0.9N.

All 200 hypotheses of both models are one batch (batched `torch.linalg.svd`,
broadcast over the matches) where the JAX package maps `jax.vmap` over them;
the 12 motion hypotheses likewise.  `_fit_F`, `_fit_H`, `_score_F`,
`_score_H` and `_check_rt` therefore take leading batch dimensions.

The RANSAC sample indices are an argument of `reconstruct` (`idx`), drawn
from `generator` when left out: JAX's and torch's generators give different
draws from the same seed, so a test that compares the two packages hands
both the same indices.

Singular vectors are defined up to sign, so F and H here and in the JAX
package agree up to sign; scores, inlier sets and the set of motion
hypotheses do not depend on it, and the cheirality count picks the same
physical motion.  `torch.argmax` keeps the first maximum, as `jnp.argmax`.
Nothing here reads a value back to the host but the draw of the samples
with a CPU generator from a card's matches (`ops/sampling.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie, sampling, triangulate
from ..slam_map.state import _row, _set_at

RANSAC_ITERS = 200
SAMPLE_SIZE = 8
CHI2_F = 3.841
CHI2_SCORE = 5.991
CHI2_H = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
COS_PARALLAX_MAX = 0.99998


class TwoViewResult(NamedTuple):
    success: torch.Tensor       # () bool
    R21: torch.Tensor           # (3,3) pose of cam2 wrt cam1 (x2 = R x1 + t)
    t21: torch.Tensor           # (3,)
    points3d: torch.Tensor      # (N,3) in cam1 frame
    triangulated: torch.Tensor  # (N,) bool
    used_homography: torch.Tensor  # () bool


def _mat3(rows) -> torch.Tensor:
    """3x3 tensor from nested lists of 0-d tensors and Python floats."""
    ref = next(x for r in rows for x in r if isinstance(x, torch.Tensor))
    return torch.stack([torch.stack([
        x if isinstance(x, torch.Tensor) else torch.full_like(ref, x) for x in r])
        for r in rows])


def _normalize(pts: torch.Tensor, w: torch.Tensor):
    """Mean / mean-absolute-deviation normalization (reference Normalize)."""
    wsum = torch.sum(w) + 1e-9
    mean = torch.sum(pts * w[:, None], dim=0) / wsum
    d = torch.abs(pts - mean)
    mdev = torch.sum(d * w[:, None], dim=0) / wsum
    s = 1.0 / (mdev + 1e-9)
    T = _mat3([[s[0], 0.0, -mean[0] * s[0]],
               [0.0, s[1], -mean[1] * s[1]],
               [0.0, 0.0, 1.0]])
    return (pts - mean) * s, T


def _fit_F(p1: torch.Tensor, p2: torch.Tensor,
           w: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized 8-point algorithm: p1, p2 (..., M, 2), optional row
    weights (..., M).  Returns (..., 3, 3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)  # (..., M, 9)
    if w is not None:
        A = A * w[..., None]
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    F = Vh[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    # rank-2 enforcement
    U, D, Vh2 = torch.linalg.svd(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return (U * D[..., None, :]) @ Vh2


def _fit_H(p1: torch.Tensor, p2: torch.Tensor,
           w: torch.Tensor | None = None) -> torch.Tensor:
    """DLT homography (reference ComputeH21), optional row weights."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2M, 9)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    return Vh[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def _score_F(F21, p1, p2, valid, sigma2: float):
    """Symmetric epipolar chi2 scoring (reference CheckFundamental).  F21
    (..., 3, 3); p1, p2 (N, 2).  Returns (score (...,), inliers (..., N))."""
    h1, h2 = _homog(p1), _homog(p2)
    l2 = torch.einsum("nj,...ij->...ni", h1, F21)  # epiline in img2
    l1 = torch.einsum("nj,...ji->...ni", h2, F21)  # epiline in img1
    inv_s2 = 1.0 / sigma2
    d2 = torch.sum(l2 * h2, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = torch.sum(l1 * h1, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    chi1 = d2 * inv_s2
    chi2_ = d1 * inv_s2
    ok = (chi1 <= CHI2_F) & (chi2_ <= CHI2_F) & valid
    score = torch.sum(
        torch.where(valid & (chi1 <= CHI2_F), CHI2_SCORE - chi1, 0.0) +
        torch.where(valid & (chi2_ <= CHI2_F), CHI2_SCORE - chi2_, 0.0), dim=-1)
    return score, ok


def _score_H(H21, p1, p2, valid, sigma2: float):
    """Symmetric transfer error scoring (reference CheckHomography)."""
    eye = torch.eye(3, dtype=H21.dtype, device=H21.device)
    H12 = torch.linalg.inv(H21 + eye * 1e-12)
    h1, h2 = _homog(p1), _homog(p2)
    q2 = torch.einsum("nj,...ij->...ni", h1, H21)
    q2 = q2[..., :2] / (q2[..., 2:3] + 1e-12)
    q1 = torch.einsum("nj,...ij->...ni", h2, H12)
    q1 = q1[..., :2] / (q1[..., 2:3] + 1e-12)
    inv_s2 = 1.0 / sigma2
    chi1 = torch.sum((p2 - q2) ** 2, dim=-1) * inv_s2
    chi2_ = torch.sum((p1 - q1) ** 2, dim=-1) * inv_s2
    ok = (chi1 <= CHI2_H) & (chi2_ <= CHI2_H) & valid
    score = torch.sum(
        torch.where(valid & (chi1 <= CHI2_H), CHI2_H - chi1, 0.0) +
        torch.where(valid & (chi2_ <= CHI2_H), CHI2_H - chi2_, 0.0), dim=-1)
    return score, ok


def _check_rt(R, t, p1, p2, inliers, K4, sigma2: float):
    """Cheirality + reprojection check of motion hypotheses (reference
    CheckRT).  R (..., 3, 3), t (..., 3); p1, p2 (N, 2).  Returns (nGood
    (...,), parallax_deg (...,), X (..., N, 3), good (..., N))."""
    n = p1.shape[0]
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    one = torch.ones(n, dtype=p1.dtype, device=p1.device)
    ray1 = torch.stack([(p1[:, 0] - cx) / fx, (p1[:, 1] - cy) / fy, one], dim=1)
    ray2 = torch.stack([(p2[:, 0] - cx) / fx, (p2[:, 1] - cy) / fy, one], dim=1)
    bshape = R.shape[:-2] + (n,)
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device)
    X = triangulate.triangulate_dlt(
        ray1.expand(bshape + (3,)), ray2.expand(bshape + (3,)),
        eye.expand(bshape + (3, 3)), torch.zeros(bshape + (3,), device=p1.device),
        R[..., None, :, :].expand(bshape + (3, 3)), t[..., None, :].expand(bshape + (3,)))
    finite = torch.all(torch.isfinite(X), dim=-1)
    O2 = -torch.einsum("...ji,...j->...i", R, t)
    n1 = X
    n2 = X - O2[..., None, :]
    d1 = torch.linalg.norm(n1, dim=-1)
    d2 = torch.linalg.norm(n2, dim=-1)
    cos_par = torch.sum(n1 * n2, dim=-1) / (d1 * d2 + 1e-12)
    Xc2 = torch.einsum("...nj,...ij->...ni", X, R) + t[..., None, :]
    far = cos_par >= COS_PARALLAX_MAX  # "infinite" points skip the depth check
    depth_ok = ((X[..., 2] > 0) | far) & ((Xc2[..., 2] > 0) | far)
    e1 = torch.stack([fx * X[..., 0] / (X[..., 2] + 1e-12) + cx,
                      fy * X[..., 1] / (X[..., 2] + 1e-12) + cy], dim=-1) - p1
    e2 = torch.stack([fx * Xc2[..., 0] / (Xc2[..., 2] + 1e-12) + cx,
                      fy * Xc2[..., 1] / (Xc2[..., 2] + 1e-12) + cy], dim=-1) - p2
    th2 = 4.0 * sigma2
    reproj_ok = (torch.sum(e1 ** 2, dim=-1) <= th2) & (torch.sum(e2 ** 2, dim=-1) <= th2)
    good_count = inliers & finite & depth_ok & reproj_ok
    n_good = torch.sum(good_count.to(torch.int32), dim=-1)
    good = good_count & (cos_par < COS_PARALLAX_MAX)
    # parallax = acos of the 50th smallest cosParallax among good
    cp = torch.where(good_count, cos_par, 2.0)
    cp_sorted = torch.sort(cp, dim=-1).values
    idx = torch.clamp(n_good - 1, 0, min(50, n - 1)).long()
    cp_at = torch.gather(cp_sorted, -1, idx[..., None])[..., 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cp_at, -1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, 0.0)
    return n_good, parallax, X, good


def _decompose_E(E):
    U, _, Vh = torch.linalg.svd(E)
    t = U[:, 2]
    t = t / (torch.linalg.norm(t) + 1e-12)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vh
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _homography_motions(A):
    """Faugeras 8-motion decomposition of A = K^-1 H K (reference
    ReconstructH).  Returns (Rs (8,3,3), ts (8,3), degenerate ())."""
    U, w, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = w[0], w[1], w[2]
    degenerate = (d1 / (d2 + 1e-12) < 1.00001) | (d2 / (d3 + 1e-12) < 1.00001)
    aux1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + 1e-12), 0))
    aux3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + 1e-12), 0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    zero = torch.zeros_like(d1)
    Rs, ts = [], []

    def motion(Rp, tp):
        Rs.append(s * (U @ Rp @ Vh))
        tv = U @ tp
        ts.append(tv / (torch.linalg.norm(tv) + 1e-12))

    # case d' = d2
    root = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0))
    aux_st = root / ((d1 + d3) * d2 + 1e-12)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + 1e-12)
    for i, st in enumerate([aux_st, -aux_st, -aux_st, aux_st]):
        motion(_mat3([[ct, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct]]),
               torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3))
    # case d' = -d2
    aux_sp = root / ((d1 - d3) * d2 + 1e-12)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + 1e-12)
    for i, sp in enumerate([aux_sp, -aux_sp, -aux_sp, aux_sp]):
        motion(_mat3([[cp, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cp]]),
               torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3))
    return torch.stack(Rs), torch.stack(ts), degenerate


def sample_indices(valid: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """(RANSAC_ITERS, SAMPLE_SIZE) int64 indices drawn among the valid
    matches, independently and with replacement as the JAX package's
    categorical draw (twoview.py:247-250)."""
    w = valid.to(torch.float32) + 1e-9
    return sampling.multinomial(w, RANSAC_ITERS * SAMPLE_SIZE, generator).reshape(
        RANSAC_ITERS, SAMPLE_SIZE)


def reconstruct(xy1: torch.Tensor, xy2: torch.Tensor, valid: torch.Tensor,
                K4: torch.Tensor, idx: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                sigma: float = 1.0) -> TwoViewResult:
    """Full two-view reconstruction from matched keypoints.

    xy1, xy2: (N, 2) matched pixel coords (row i of xy1 matches row i of
    xy2); valid: (N,) mask.  K4 = [fx, fy, cx, cy].  idx: the (200, 8)
    RANSAC sample indices; None draws them from `generator` on its own
    device (`ops/sampling.multinomial`).
    """
    sigma2 = sigma * sigma
    dev = xy1.device

    # --- normalized coordinates ------------------------------------------
    vf = valid.to(torch.float32)
    p1n, T1 = _normalize(xy1, vf)
    p2n, T2 = _normalize(xy2, vf)

    # --- RANSAC sampling: (ITERS, 8) indices among valid matches ---------
    if idx is None:
        idx = sample_indices(valid, generator)
    idx = idx.long()
    s1 = p1n[idx]  # (I, 8, 2)
    s2 = p2n[idx]

    Fn = _fit_F(s1, s2)
    Hn = _fit_H(s1, s2)
    T2t = T2.T
    T2i = torch.linalg.inv(T2)
    F_all = T2t @ Fn @ T1
    H_all = T2i @ Hn @ T1

    scF, okF = _score_F(F_all, xy1, xy2, valid, sigma2)
    scH, okH = _score_H(H_all, xy1, xy2, valid, sigma2)

    bi_F = torch.argmax(scF)
    bi_H = torch.argmax(scH)
    SF, inlF = _row(scF, bi_F), _row(okF, bi_F)
    SH, inlH = _row(scH, bi_H), _row(okH, bi_H)

    # refit on all inliers of the winning hypothesis, and rescore with the
    # refit models so that the inlier sets stay consistent
    F21 = T2t @ _fit_F(p1n, p2n, inlF.to(torch.float32)) @ T1
    H21 = T2i @ _fit_H(p1n, p2n, inlH.to(torch.float32)) @ T1
    SF2, inlF2 = _score_F(F21, xy1, xy2, valid, sigma2)
    SH2, inlH2 = _score_H(H21, xy1, xy2, valid, sigma2)
    keepF = SF2 >= SF
    keepH = SH2 >= SH
    F21 = torch.where(keepF, F21, T2t @ _row(Fn, bi_F) @ T1)
    H21 = torch.where(keepH, H21, T2i @ _row(Hn, bi_H) @ T1)
    SF = torch.maximum(SF, SF2)
    SH = torch.maximum(SH, SH2)
    inlF = torch.where(keepF, inlF2, inlF)
    inlH = torch.where(keepH, inlH2, inlH)

    RH = SH / (SH + SF + 1e-12)
    use_H = RH > 0.40

    # --- motion recovery --------------------------------------------------
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    K = _mat3([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])

    # F path: 4 hypotheses
    Rf1, Rf2, tf = _decompose_E(K.T @ F21 @ K)
    RsF = torch.stack([Rf1, Rf2, Rf1, Rf2])
    tsF = torch.stack([tf, tf, -tf, -tf])

    # H path: 8 hypotheses
    RsH, tsH, h_degenerate = _homography_motions(torch.linalg.inv(K) @ H21 @ K)

    inliers = torch.where(use_H, inlH, inlF)
    Rs = torch.cat([RsF, RsH])     # (12,3,3)
    ts = torch.cat([tsF, tsH])
    hyp = torch.arange(12, device=dev)
    hyp_on = torch.where(use_H, hyp >= 4, hyp < 4)

    ng, par, Xs, goods = _check_rt(Rs, ts, xy1, xy2, inliers, K4, sigma2)
    ng = torch.where(hyp_on, ng, -1)
    best = torch.argmax(ng)
    n_best = _row(ng, best)
    n_second = torch.max(_set_at(ng, best, -1))
    N_inl = torch.sum(inliers.to(torch.int32))
    min_good = torch.clamp_min((0.9 * N_inl).to(torch.int32), MIN_TRIANGULATED)

    # acceptance per reference: F needs nsimilar<=1 (0.7 rule); H needs
    # second < 0.75*best; both need parallax and counts
    n_similar = torch.sum((ng > 0.7 * n_best).to(torch.int32))
    par_best = _row(par, best)
    ok_F = (n_best >= min_good) & (n_similar <= 1) & (par_best > MIN_PARALLAX_DEG)
    ok_H = (n_second < 0.75 * n_best) & (par_best >= MIN_PARALLAX_DEG) & \
        (n_best > MIN_TRIANGULATED) & (n_best > 0.9 * N_inl) & ~h_degenerate
    success = torch.where(use_H, ok_H, ok_F)

    return TwoViewResult(
        success=success,
        R21=lie.normalize_rotation(_row(Rs, best)),
        t21=_row(ts, best),
        points3d=_row(Xs, best),
        triangulated=_row(goods, best) & success,
        used_homography=use_H)
