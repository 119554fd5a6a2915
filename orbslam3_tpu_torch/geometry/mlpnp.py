"""MLPnP: maximum-likelihood PnP in bearing-vector nullspace form.

Counterpart of `orbslam3_tpu/geometry/mlpnp.py` (parity target: reference
MLPnPsolver, src/MLPnPsolver.cpp, the Urban et al. 2016 algorithm; RANSAC
parameters at src/Tracking.cc:839):

  * each observation is a unit bearing v_i from the camera model's
    unprojection;
  * the measurement model is the 2-D tangent-space (nullspace) residual
    J(v_i)^T u_i with u_i = (R X_i + t) / |R X_i + t| and J(v) = [r, s] an
    orthonormal basis of v's orthogonal complement;
  * the linear initialization solves the stacked constraints
    J(v_i)^T (R X_i + t) = 0: 12 unknowns [vec R | t] in general, 9 when the
    point set is planar (R's third column comes from the cross product),
    through the eigenvector of the smallest eigenvalue of the 12x12 / 9x9
    Gram matrix;
  * maximum likelihood: residuals weighted by the per-keypoint inverse pixel
    variance (octave noise model), Gauss-Newton refinement with chi2 inlier
    reclassification.

Everything is one batch: a leading dimension of B problems (the candidates of
a relocalization attempt), all RANSAC hypotheses of each, and the top-8
refinements of each, where the JAX package nests three `vmap`s.  Both linear
forms are computed for every sample and the problem's estimated planarity
selects between them.

The sample indices are an argument: JAX draws them with its own generator
(`jax.random.categorical`), which torch cannot reproduce.  Without them they
are drawn from the same weights by `ops/sampling.multinomial` with an
explicit generator, on the generator's device.

Both Gauss-Newton loops use the analytic Jacobian of the residual through
R exp(w) at w = 0, which is what `jax.jacfwd` evaluates there: with
Xc = R X + t, n = |Xc| and u = Xc / n,
    d e / d Xc = f J^T (I - u u^T) / n,   d Xc / d w = -R [X]x,   d Xc / d t = I.
The robust weights are frozen at the iterate, as in JAX.

One deliberate difference from the JAX package.  Its planar form takes the
plane basis E = [e_major, e_mid, normal] straight from `eigh`, which returns
a left-handed basis as readily as a right-handed one.  The planar solve builds
a right-handed [m1, m2, m1 x m2] = s R E', with E' the right-handed version
of E, and then undoes the basis with E^T: for a left-handed E the result
R E' E^T is R times the reflection through the plane, a matrix of
determinant -1 that projects every point of the plane exactly as the true
pose does, collects every inlier and wins.  On `bench.py`'s ground plane the
JAX `solve_mlpnp` returns such a reflection for most candidate keyframes, and
the frame tracked from it has no inliers.  A pose must be a rotation, so this
module makes E right-handed first (the normal's sign is flipped when det(E)
< 0); with a right-handed E the two packages agree.

Two properties of the reference that callers should know.  The eigenvector's
sign is arbitrary.  The general form is immune: `_fix_pose` divides by the
signed cube root of det(M), and [-M | -t] normalizes to the same pose.  The
planar form is not: its third column is a cross product, the determinant is
positive for u and for -u, and -u gives the mirrored pose (every point behind
its bearing), which the cheirality term of the scoring then rejects.  Which
of the two a sample gets depends on the eigensolver (LAPACK, cuSOLVER), so on
a planar scene the surviving hypotheses differ between libraries and devices
while the refined winner does not.  And on a planar point set the general
form's Gram matrix has a null space of more than one dimension, so its result
is arbitrary; only the select on `planar` keeps it out.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import cameras, lie, sampling
from ..solver import robust

TOP_K = 8   # hypotheses refined (LO-RANSAC)


class MLPnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def bearing_nullspace(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit bearings -> (..., 3, 2) orthonormal tangent bases J(v)
    (the nullspace of v^T): cross with the axis least aligned with v."""
    use_z = (torch.abs(v[..., 2]) < 0.9).to(v.dtype)
    a = torch.stack([1.0 - use_z, torch.zeros_like(use_z), use_z], dim=-1)
    r = torch.linalg.cross(v, a, dim=-1)
    r = r / torch.clamp_min(torch.linalg.norm(r, dim=-1, keepdim=True), 1e-12)
    s = torch.linalg.cross(v, r, dim=-1)
    return torch.stack([r, s], dim=-1)


def _smallest_eigvec(G: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (..., D, D)."""
    _, V = torch.linalg.eigh(G)
    return V[..., :, 0]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Signed cube root (`jnp.cbrt`)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _fix_pose(M: torch.Tensor, t: torch.Tensor):
    """Common tail of both linear forms: normalize the raw [M | t] estimate
    by the signed cube root of det(M) and project M onto SO(3)."""
    det = lie.det3(M)
    scale = torch.sign(det) * _cbrt(torch.abs(det) + 1e-20)
    scale = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
    return lie.normalize_rotation_svd(M / scale[..., None, None]), t / scale[..., None]


def _tangent_rows(X: torch.Tensor, J: torch.Tensor):
    """Both tangent directions of every point stacked: (d (..., 2S, 3),
    X repeated (..., 2S, 3))."""
    return (torch.cat([J[..., 0], J[..., 1]], dim=-2), torch.cat([X, X], dim=-2))


def _solve_general(X: torch.Tensor, J: torch.Tensor):
    """12-unknown nullspace DLT on samples X (..., S, 3), J (..., S, 3, 2):
    rows J^T (R X + t) = 0."""
    d, Xr = _tangent_rows(X, J)
    A_R = (d[..., :, None] * Xr[..., None, :]).flatten(-2)        # (..., 2S, 9)
    A = torch.cat([A_R, d], dim=-1)                               # (..., 2S, 12)
    u = _smallest_eigvec(A.transpose(-1, -2) @ A)
    return _fix_pose(u[..., :9].reshape(u.shape[:-1] + (3, 3)), u[..., 9:12])


def _solve_planar(X: torch.Tensor, J: torch.Tensor, E: torch.Tensor, c: torch.Tensor):
    """9-unknown planar form: points rotated into the plane basis E
    (..., 3, 3) about the centroid c (..., 3), both broadcast against the
    samples' leading dimensions; only R's first two columns enter."""
    Xp = (X - c[..., None, :]) @ E                                # (..., S, 3)
    d, Xr = _tangent_rows(Xp, J)
    A_R = (d[..., :, None] * Xr[..., None, :2]).flatten(-2)       # (..., 2S, 6)
    A = torch.cat([A_R, d], dim=-1)                               # (..., 2S, 9)
    u = _smallest_eigvec(A.transpose(-1, -2) @ A)
    # u[:6] reshaped (3, 2) = the first two columns of s*R; the third column
    # (s*r1 x s*r2 = s^2 * r3) is rescaled back to s
    M2 = u[..., :6].reshape(u.shape[:-1] + (3, 2))
    m1, m2 = M2[..., 0], M2[..., 1]
    s_est = torch.sqrt(torch.linalg.norm(m1, dim=-1) * torch.linalg.norm(m2, dim=-1) + 1e-20)
    c3 = torch.linalg.cross(m1, m2, dim=-1) / torch.clamp_min(s_est, 1e-12)[..., None]
    Rp, tp = _fix_pose(torch.cat([M2, c3[..., None]], dim=-1), u[..., 6:9])
    # undo the plane basis: x_c = Rp (E^T (X - c)) + tp
    R = Rp @ E.transpose(-1, -2)
    return R, tp - lie._mv(R, c)


def _apply(R, t, X):
    """R X + t for R (..., 3, 3), t (..., 3), X (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]


def _nullspace_residuals(R, t, X, J, f_scale):
    """(..., N, 2) tangent-space residuals of the unit-projected points,
    scaled by the focal length so that magnitudes are pixel-comparable."""
    Xc = _apply(R, t, X)
    u = Xc / torch.clamp_min(torch.linalg.norm(Xc, dim=-1, keepdim=True), 1e-9)
    return f_scale * torch.einsum("...njk,...nj->...nk", J, u)


def _gn_step(R, t, X, J, f_scale, damping: float, weight_fn=None):
    """One Gauss-Newton step on (w, t) at R exp(w), t + dt.  `weight_fn`
    maps the unweighted residuals (..., N, 2) to per-point factors
    (..., N) that scale residual and Jacobian and are not differentiated."""
    Xc = _apply(R, t, X)
    n = torch.clamp_min(torch.linalg.norm(Xc, dim=-1, keepdim=True), 1e-9)
    u = Xc / n
    Ju = torch.einsum("...njk,...nj->...nk", J, u)                # (..., N, 2)
    e = f_scale * Ju
    # f J^T (I - u u^T) / n
    dE = f_scale * (J.transpose(-1, -2) - Ju[..., :, None] * u[..., None, :]) / n[..., None]
    dW = -dE @ torch.einsum("...ij,...njk->...nik", R, lie.hat(X))
    Jr = torch.cat([dW, dE], dim=-1)                              # (..., N, 2, 6)
    if weight_fn is not None:
        sw = weight_fn(e)
        e = e * sw[..., None]
        Jr = Jr * sw[..., None, None]
    H = torch.einsum("...nki,...nkj->...ij", Jr, Jr)
    H = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    g = -torch.einsum("...nki,...nk->...i", Jr, e)
    # no status read: a singular system gives a non-finite step, which the
    # scoring then rejects, as `jnp.linalg.solve` does
    dx = torch.linalg.solve_ex(H, g[..., None], check_errors=False).result[..., 0]
    R2 = lie.normalize_rotation(R @ lie.exp_so3(dx[..., 0:3]))
    return R2, t + dx[..., 3:6]


def solve_mlpnp(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                cam_model: str, cam_params, idx: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                iterations: int = 256, sample: int = 6, chi2_th: float = 5.991,
                min_inliers: int = 30, inv_sigma2=None, gn_rounds: int = 3,
                gn_iters: int = 6) -> MLPnPResult:
    """RANSAC MLPnP + maximum-likelihood Gauss-Newton refinement.

    X (N, 3) world points matched to uv (N, 2) pixels, `valid` (N,) bool,
    `inv_sigma2` (N,) the per-keypoint inverse pixel variance; or B problems
    at once with a leading dimension on X and `valid` (and optionally on uv
    and `inv_sigma2`), every field of the result then with a leading B.
    `idx`: (iterations, sample) or (B, iterations, sample) sample indices;
    drawn with `generator` from the weights valid * inv_sigma2 + 1e-9 when
    absent.  Residuals are scaled by the focal length so that `chi2_th` keeps
    its pixel meaning."""
    batched = X.dim() == 3
    if not batched:
        X, valid = X[None], valid[None]
        idx = None if idx is None else idx[None]
    B, N = X.shape[:2]
    dev = X.device
    cam_params = torch.as_tensor(cam_params, dtype=torch.float32, device=dev)
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones(N, dtype=torch.float32, device=dev)
    inv_sigma2 = inv_sigma2.expand(B, N)
    f_scale = cam_params[0]
    rays = cameras.unproject(cam_model, cam_params, uv)
    v = rays / torch.clamp_min(torch.linalg.norm(rays, dim=-1, keepdim=True), 1e-9)
    v = v.expand(B, N, 3)
    J = bearing_nullspace(v)                                      # (B, N, 3, 2)

    # planarity of each valid point set (the reference eigen-decomposes the
    # point scatter to pick the planar path)
    w = valid.to(torch.float32)
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1.0)[:, None]
    c = torch.sum(X * w[..., None], dim=1) / wsum                 # (B, 3)
    Xc_ = (X - c[:, None, :]) * w[..., None]
    S3 = Xc_.transpose(-1, -2) @ Xc_ / wsum[..., None]
    evals, E = torch.linalg.eigh(S3)                              # ascending
    planar = evals[:, 0] < 1e-3 * torch.clamp_min(evals[:, 2], 1e-12)
    # plane basis: largest two eigenvectors first, normal last; made
    # right-handed (an eigensolver returns either handedness), see above
    normal = E[..., 0] * torch.where(lie.det3(E) > 0, -1.0, 1.0)[:, None]
    E_plane = torch.stack([E[..., 2], E[..., 1], normal], dim=-1)

    # importance-sample the minimal sets toward low-noise observations
    if idx is None:
        wp = w * inv_sigma2 + 1e-9
        idx = sampling.multinomial(wp, iterations * sample, generator).reshape(
            B, iterations, sample)
    idx = idx.long()
    ar = torch.arange(B, device=dev)
    Xs, Js = X[ar[:, None, None], idx], J[ar[:, None, None], idx]  # (B, H, S, 3[, 2])

    Rg, tg = _solve_general(Xs, Js)
    Rp, tp = _solve_planar(Xs, Js, E_plane[:, None], c[:, None])
    Rs = torch.where(planar[:, None, None, None], Rp, Rg)
    ts = torch.where(planar[:, None, None], tp, tg)
    # plain GN on the minimal sample (reference mlpnp_gn inside computePose):
    # the exactly determined linear solve is noise-fragile
    for _ in range(3):
        Rs, ts = _gn_step(Rs, ts, Xs, Js, f_scale, 1e-5)

    def classify(R, t, th):
        """Inlier masks (..., N) of poses (B, M, ...) against all points."""
        e = _nullspace_residuals(R, t, X[:, None], J[:, None], f_scale)
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2[:, None]
        depth_ok = torch.sum(v[:, None] * _apply(R, t, X[:, None]), dim=-1) > 0.01
        return (chi2 < th) & valid[:, None] & depth_ok

    inls = classify(Rs, ts, 4.0 * chi2_th)                        # (B, H, N)
    counts = torch.sum(inls.to(torch.int32), dim=-1)
    # LO-RANSAC: refine the top-k scoring hypotheses (the lower index first
    # on a tie, as `lax.top_k`) and keep the one with the most final inliers
    cand = torch.sort(counts, dim=-1, descending=True, stable=True).indices[:, :TOP_K]
    R, t, inl = Rs[ar[:, None], cand], ts[ar[:, None], cand], inls[ar[:, None], cand]

    Xb, Jb = X[:, None], J[:, None]
    delta = math.sqrt(chi2_th)
    for _ in range(gn_rounds):
        aw = inl.to(torch.float32) * inv_sigma2[:, None]

        def irls(e0):
            hub = robust.huber_weight(torch.sum(e0 * e0, dim=-1) * inv_sigma2[:, None], delta)
            return torch.sqrt(aw * hub)

        for _ in range(gn_iters):
            R, t = _gn_step(R, t, Xb, Jb, f_scale, 1e-6, irls)
        inl = classify(R, t, chi2_th)
    nf = torch.sum(inl.to(torch.int32), dim=-1)                   # (B, 8)
    best = torch.argmax(nf, dim=-1)
    n_inl = nf[ar, best]
    res = MLPnPResult(success=n_inl >= min_inliers, R=R[ar, best], t=t[ar, best],
                      inliers=inl[ar, best], n_inliers=n_inl)
    return res if batched else MLPnPResult(*(x[0] for x in res))
