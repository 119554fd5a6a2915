"""Distributed Schur-complement bundle adjustment over a mesh of shards.

Counterpart of `orbslam3_tpu/parallel/dist_ba.py`: map points and their
observations are sharded; each shard marginalizes its own points and the
reduced camera system is solved by PCG whose K-sized contractions are psums
over the mesh (`parallel.multihost.Mesh`): the same `solver.ba._solve_schur`
as on one device, with its `reduce` hook.

Where JAX runs the LM loop under `shard_map`, the port gives one process all
of its local shards at once, side by side: the process's point block is its
shards' blocks in order, its observation rows likewise, and the cameras are
repeated once per shard, so that every K-sized segment sum keeps one
partial per shard, which `Mesh.psum` sums over the local shards and then
all-reduces across processes.  The LM accept/reject stays on the device
(`torch.where` on the carried state); the only host waits are the
collectives' own.

Sharding invariant: all observations of a point live on that point's shard
(`partition_problem` repacks them once per solve).  The solve returns whole
tensors of the input's shapes on every process: X gathered over the shards
(in the input's point order, which `partition_problem` never changes), R, t
and the cost replicated.
"""

from __future__ import annotations

import torch

from ..ops import lie
from ..slam_map.state import _set_drop_last
from ..solver import ba as ba_mod
from ..solver.ba import BAProblem


def partition_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Repack the observations so that shard s owns points [s*P/n,
    (s+1)*P/n) and all of their observations, valid ones first (padded per
    shard).  A shard with more than O/n observations drops the excess, as
    JAX does: its dropped rows write their fill into the shard's last slot,
    after the last kept row, and the last write wins (T13)."""
    P_cap = prob.X.shape[0]
    O_cap = prob.obs_cam.shape[0]
    assert P_cap % n_shards == 0, "point capacity must divide shard count"
    assert O_cap % n_shards == 0, "obs capacity must divide shard count"
    pts_per = P_cap // n_shards
    obs_per = O_cap // n_shards
    dev = prob.obs_pt.device

    shard_of_obs = torch.clamp(torch.div(prob.obs_pt.long(), pts_per, rounding_mode="floor"),
                               0, n_shards - 1)
    key = shard_of_obs * 2 + (~prob.obs_valid).long()
    # JAX sorts the unique key * O + row; a stable sort of the key is the
    # same order (T3)
    order = torch.argsort(key, stable=True)
    sh = shard_of_obs[order]
    ar = torch.arange(O_cap, device=dev)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sh[1:] != sh[:-1]])
    pos_in_shard = ar - torch.cummax(torch.where(start, ar, 0), 0).values
    keep = pos_in_shard < obs_per
    dst = sh * obs_per + torch.clamp_max(pos_in_shard, obs_per - 1)

    def scatter(arr, fill):
        out = torch.full((O_cap,) + arr.shape[1:], fill, dtype=arr.dtype, device=dev)
        kk = keep.reshape((-1,) + (1,) * (arr.dim() - 1))
        return _set_drop_last(out, dst, torch.where(kk, arr[order], out[dst]))

    out = prob._replace(
        obs_cam=scatter(prob.obs_cam, 0),
        obs_pt=scatter(prob.obs_pt, 0),
        obs_uv=scatter(prob.obs_uv, 0.0),
        obs_inv_sigma2=scatter(prob.obs_inv_sigma2, 1.0),
        obs_valid=scatter(prob.obs_valid, False))
    if prob.obs_ur is not None:
        out = out._replace(obs_ur=scatter(prob.obs_ur, -1.0))
    return out


def _dense_reduced_local(Hpp, bp, Cobs, cam_row, lo_pt, lam, pt_valid, n_local: int, K: int):
    """Each local shard's pieces of the dense reduced camera system:
    (S_off_l (L, K, 6, K, 6), rv_l (L, K, 6), Hpp_inv), where over the mesh

      S = blockdiag(Hcc + lam I) - psum(S_off_l)
      rhs = (psum(bc_l) - psum(rv_l)) * free.

    S_off is assembled without the (K, P, 6, 3) coupling tensor of the whole
    map: the Cholesky-split scatter G[cam, pt] += Cobs L_pt over the shard's
    own point block, then G G^T as one batched product."""
    P_l = Hpp.shape[0] // n_local
    Hpp_inv = ba_mod._damped_points(Hpp, lam, pt_valid)
    U = torch.einsum("nij,njl->nil", Cobs, ba_mod._chol3(Hpp_inv)[lo_pt])
    G = ba_mod._seg_sum(n_local * K * P_l, cam_row * P_l + lo_pt % P_l, U)
    Gr = G.reshape(n_local, K, P_l, 6, 3).permute(0, 1, 3, 2, 4).reshape(n_local, K * 6, P_l * 3)
    S_off_l = torch.bmm(Gr, Gr.transpose(1, 2)).reshape(n_local, K, 6, K, 6)
    CW = torch.einsum("nij,njl->nil", Cobs, Hpp_inv[lo_pt])
    rv = torch.einsum("nil,nl->ni", CW, bp[lo_pt])
    rv_l = ba_mod._seg_sum(n_local * K, cam_row, rv).reshape(n_local, K, 6)
    return S_off_l, rv_l, Hpp_inv


def _dense_pcg(S, rhs, free, pcg_iters: int):
    """Replicated PCG on the dense reduced system (K, 6, K, 6) with the exact
    block-Jacobi preconditioner: all local, no collective."""
    K = rhs.shape[0]
    ar = torch.arange(K, device=S.device)
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    D_inv = torch.linalg.inv_ex(S[ar, :, ar, :] + eye6 * 1e-8).inverse

    def mv(x):
        y = torch.einsum("kilj,lj->ki", S, x)
        return y * free[:, None] + x * (1 - free)[:, None]

    dx = ba_mod._pcg(mv, lambda r: torch.einsum("kij,kj->ki", D_inv, r), rhs, pcg_iters)
    return dx * free[:, None]


def dist_bundle_adjust(prob: BAProblem, mesh, axis: str = "shard",
                       cam_model: str = "pinhole", cam_params=None,
                       iterations: int = 5, lam0: float = 1e-4,
                       chi2_th: float = 5.991, use_robust: bool = True,
                       pcg_iters: int = 32, comm: str = "matvec"):
    """Distributed LM: points and observations sharded over `mesh`.

    `prob` is the whole problem, already partitioned with
    `partition_problem(prob, mesh.size)`, the same on every process.
    Returns (R, t, X, cost) with the input's shapes on every process.

    comm modes, as in JAX (collectives per LM iteration, counted by
    `mesh.n_collectives`):
      * "matvec": the psum inside every PCG matvec, through
        `_solve_schur(reduce=)`: Hcc, bc and the cost, the rhs and the
        preconditioner, one per PCG step and the new cost (pcg_iters + 6;
        JAX's docstring counts ~35 at 32 steps).
      * "dense": communication-avoiding: each shard assembles its dense
        reduced-system contribution, one batched psum ships {S_off, Hcc,
        bc, rv, cost} together, and the (6K)^2 reduced solve runs
        replicated with a local PCG: 2 collectives (the assembly and the
        accept test's cost).
      * "camshard": keyframe-block-sharded reduced system: every shard owns
        K/n camera rows of S, the rhs and the preconditioner, the PCG state
        is sharded, and each matvec costs one all_gather(x) and psums
        (4 + 4 * pcg_iters).
    """
    n = mesh.shape[axis]
    L = mesh.local
    P_cap, O_cap, K = prob.X.shape[0], prob.obs_cam.shape[0], prob.R.shape[0]
    pts_per, obs_per = P_cap // n, O_cap // n
    assert K % n == 0 or comm != "camshard", "camshard needs cameras divisible by shard count"
    dev, dt = prob.R.device, prob.R.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)

    # this process's shards, side by side
    first = mesh.rank * L
    pts = slice(first * pts_per, (first + L) * pts_per)
    obs = slice(first * obs_per, (first + L) * obs_per)
    shard = torch.arange(L * obs_per, device=dev) // obs_per        # local shard of a row
    obs_pt = prob.obs_pt[obs].long()
    pt_base = (first + shard) * pts_per
    # obs_pt rebased into the shard's block, then into the process's
    lo_pt = shard * pts_per + torch.clamp(obs_pt - pt_base, 0, pts_per - 1)
    lo_valid = prob.obs_valid[obs] & (obs_pt >= pt_base) & (obs_pt < pt_base + pts_per)
    ci = prob.obs_cam[obs].long()
    cam_row = shard * K + ci                                         # the shard's own camera row
    pt_valid = prob.pt_valid[pts]

    def tile(a):
        return a.repeat((L,) + (1,) * (a.dim() - 1))

    shard_prob = BAProblem(
        R=tile(prob.R), t=tile(prob.t), cam_fixed=tile(prob.cam_fixed),
        cam_valid=tile(prob.cam_valid), X=prob.X[pts], pt_valid=pt_valid,
        obs_cam=cam_row, obs_pt=lo_pt, obs_uv=prob.obs_uv[obs],
        obs_inv_sigma2=prob.obs_inv_sigma2[obs], obs_valid=lo_valid)
    free = (~prob.cam_fixed).to(dt)
    delta = chi2_th ** 0.5

    def psum_cams(v):
        """Per-observation rows -> (K, ...): each shard's segment sum, psum'd."""
        return mesh.psum(ba_mod._seg_sum(L * K, cam_row, v).reshape((L, K) + v.shape[1:]))

    def shard_costs(chi2, m):
        c = ba_mod._huber_cost(chi2, delta) if use_robust else chi2
        return (c * m.to(dt)).reshape(L, obs_per).sum(1)

    def cost_at(R, t, X):
        e, _ = ba_mod._residuals(shard_prob, tile(R), tile(t), X, cam_model, cam_params)
        chi2 = torch.sum(e * e, dim=-1) * shard_prob.obs_inv_sigma2
        return shard_costs(chi2, ba_mod._obs_mask(shard_prob))

    def solve_dense(Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam):
        """One batched psum ships every global quantity of this iteration's
        normal equations; everything after is local."""
        S_off_l, rv_l, Hpp_inv = _dense_reduced_local(Hpp, bp, Cobs, cam_row, lo_pt, lam,
                                                      pt_valid, L, K)
        flat = mesh.psum(torch.cat([S_off_l.reshape(L, -1), Hcc_l.reshape(L, -1),
                                    bc_l.reshape(L, -1), rv_l.reshape(L, -1), cost_l[:, None]], 1))
        nS, nH = K * 6 * K * 6, K * 36
        S_off = flat[:nS].reshape(K, 6, K, 6)
        Hcc = flat[nS:nS + nH].reshape(K, 6, 6)
        bc = flat[nS + nH:nS + nH + K * 6].reshape(K, 6)
        rv = flat[nS + nH + K * 6:nS + nH + 2 * K * 6].reshape(K, 6)
        ar = torch.arange(K, device=dev)
        S = ba_mod._add_blocks(-S_off, ar, ar, Hcc + lam * eye6)
        S = S * (free[:, None, None, None] * free[None, None, :, None])
        S = ba_mod._add_blocks(S, ar, ar, eye6 * (1 - free)[:, None, None])
        dx_cam = _dense_pcg(S, (bc - rv) * free[:, None], free, pcg_iters)
        dx_pt = ba_mod._back_substitute(Cobs, dx_cam, Hpp_inv, bp, ci, lo_pt, pt_valid)
        return dx_cam, dx_pt, flat[-1]

    def solve_camshard(Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam):
        """Keyframe-block-sharded reduced solve: the process's shards own
        camera rows [first*Kl, (first+L)*Kl); each matvec all_gathers the
        K-vector and psums the scattered coupling back to rows."""
        Kl = K // n
        rows = torch.arange(first * Kl, (first + L) * Kl, device=dev)
        flat = mesh.psum(torch.cat([Hcc_l.reshape(L, -1), bc_l.reshape(L, -1),
                                    cost_l[:, None]], 1))
        Hcc = flat[:K * 36].reshape(K, 6, 6)
        bc = flat[K * 36:K * 36 + K * 6].reshape(K, 6)
        Hcc_d = Hcc + lam * eye6
        P_l = Hpp.shape[0]
        Hpp_inv = ba_mod._damped_points(Hpp, lam, pt_valid)
        CW = torch.einsum("nij,njl->nil", Cobs, Hpp_inv[lo_pt])
        free_l = free[rows]

        def matvec_rows(xg):
            """Full x (K, 6) in, the process's rows of S x out."""
            xm = xg * free[:, None]
            u = torch.einsum("nij,ni->nj", Cobs, xm[ci])
            v = torch.einsum("nil,nl->ni", CW, ba_mod._seg_sum(P_l, lo_pt, u)[lo_pt])
            y = torch.einsum("kij,kj->ki", Hcc_d[rows], xm[rows]) - psum_cams(v)[rows]
            return y * free_l[:, None] + xg[rows] * (1 - free_l)[:, None]

        # rhs rows + exact block-Jacobi rows
        rv = torch.einsum("nil,nl->ni", CW, bp[lo_pt])
        Dn = torch.einsum("nil,nml->nim", CW, Cobs)
        packed = mesh.psum(torch.cat([
            ba_mod._seg_sum(L * K, cam_row, rv).reshape(L, -1),
            ba_mod._seg_sum(L * K, cam_row, Dn).reshape(L, -1)], 1))
        rv_g = packed[:K * 6].reshape(K, 6)
        D_off = packed[K * 6:].reshape(K, 6, 6)
        r = (bc[rows] - rv_g[rows]) * free_l[:, None]
        D = Hcc_d[rows] - D_off[rows]
        D = D * free_l[:, None, None] + eye6 * (1 - free_l)[:, None, None]
        D_inv = torch.linalg.inv_ex(D + eye6 * 1e-8).inverse

        def precond(r_):
            return torch.einsum("kij,kj->ki", D_inv, r_)

        def gather_rows(x_l):
            return mesh.all_gather(x_l.reshape(L, Kl, 6))

        def dot(a, b):
            return (a * b).reshape(L, -1).sum(1)       # one partial per shard

        x = torch.zeros_like(r)
        z = precond(r)
        p = z
        for _ in range(pcg_iters):
            Ap = matvec_rows(gather_rows(p))
            dots = mesh.psum(torch.stack([dot(r, z), dot(p, Ap)], 1))
            rz, den = dots[0], dots[1]
            al = rz / torch.where(torch.abs(den) < 1e-20, 1e-20, den)
            x = x + al * p
            r = r - al * Ap
            z = precond(r)
            be = mesh.psum(dot(r, z)) / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
            p = z + be * p
        dx_cam = gather_rows(x * free_l[:, None]) * free[:, None]
        dx_pt = ba_mod._back_substitute(Cobs, dx_cam, Hpp_inv, bp, ci, lo_pt, pt_valid)
        return dx_cam, dx_pt, flat[-1]

    R, t, X = prob.R, prob.t, shard_prob.X
    lam = torch.full((), lam0, dtype=dt, device=dev)
    cost = torch.full((), float("inf"), dtype=dt, device=dev)
    for _ in range(iterations):
        Hcc_l, bc_l, Hpp, bp, Cobs, _, chi2, m = ba_mod._build_normal_eq(
            shard_prob, tile(R), tile(t), X, cam_model, cam_params, chi2_th, use_robust)
        cost_l = shard_costs(chi2, m)
        if comm == "dense":
            dx_cam, dx_pt, cur = solve_dense(Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam)
        elif comm == "camshard":
            dx_cam, dx_pt, cur = solve_camshard(Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam)
        else:
            Hcc = mesh.psum(Hcc_l.reshape(L, K, 6, 6))
            bc = mesh.psum(bc_l.reshape(L, K, 6))
            cur = mesh.psum(cost_l)
            dx_cam, dx_pt = ba_mod._solve_schur(Hcc, bc, Hpp, bp, Cobs, ci, lo_pt, lam,
                                                prob.cam_fixed, pt_valid, pcg_iters=pcg_iters,
                                                reduce=psum_cams)
        dR, dtr = lie.se3_exp(dx_cam)
        R2, t2 = lie.se3_compose(dR, dtr, R, t)
        R2 = lie.normalize_rotation(R2)
        X2 = X + dx_pt
        new = mesh.psum(cost_at(R2, t2, X2))
        ok = new < cur
        R = torch.where(ok, R2, R)
        t = torch.where(ok, t2, t)
        X = torch.where(ok, X2, X)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.minimum(new, cur)
    return R, t, mesh.all_gather(X.reshape(L, pts_per, 3)), cost
