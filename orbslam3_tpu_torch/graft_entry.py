"""Entry points: the one-frame step on one device, and a dry run of the
sharded BA.  Counterpart of the repository's `__graft_entry__.py` (`entry`,
`dryrun_multichip`).  Both run on the first CUDA device unless the caller
names another."""

from __future__ import annotations

import numpy as np
import torch

K4 = (458.654, 457.296, 367.215, 248.375)


def _device(device):
    return torch.device("cuda", 0) if device is None else torch.device(device)


def entry(device=None):
    """(fn, example_args): the forward step of the flagship pipeline on one
    frame, ORB extraction and local-map tracking, with a random image and an
    empty map of 64 keyframes / 8192 points / 65536 observations."""
    from .features.extractor import OrbParams, extract
    from .pipeline import tracking
    from .slam_map import state as mapstate

    dev = _device(device)
    p = OrbParams(n_features=1200, n_levels=8)
    cam = torch.tensor(K4, dtype=torch.float32, device=dev)
    m = mapstate.empty_map(mapstate.MapCapacity(n_kf=64, n_pt=8192, n_obs=65536), dev)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 255, (480, 752)).astype(np.float32)).to(dev)

    def step(img, m):
        ff = extract(img, p)
        eye = torch.eye(3, device=img.device)
        tr = tracking.track_local_map(m, ff, eye, torch.zeros(3, device=img.device),
                                      "pinhole", cam, (480, 752))
        return tr.R, tr.t, tr.n_inliers

    return step, (img, m)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the pipeline's sharded local-BA step (`mapping.run_local_ba`
    with a mesh, the path `SlamConfig.ba_mesh_shards > 1` takes) on a mesh
    of `n_devices` shards, on a small map built through the map-state API;
    then `dist_ba`'s two other collective schemes, "dense" and "camshard",
    on a synthetic problem.  Raises when a pose comes out non-finite.  The
    port's mesh holds its shards on one device; the random points come
    from NumPy generators seeded 0 and 1 where JAX draws them from
    `PRNGKey(0)` and `PRNGKey(1)`."""
    from .ops import cameras, lie
    from .parallel import dist_ba, multihost
    from .pipeline import mapping
    from .slam_map import state as mapstate
    from .solver import ba as ba_mod

    dev = _device(device)
    cam = torch.tensor(K4, dtype=torch.float32, device=dev)
    n_cams = 4
    n_pts = 16 * n_devices
    cap = mapstate.MapCapacity(n_kf=8, n_pt=max(16 * n_devices, 64),
                               n_obs=max(64 * n_devices, 256))

    def normal(seed, shape):
        x = np.random.default_rng(seed).normal(size=shape) * 0.5 + [0.0, 0.0, 6.0]
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    X = normal(0, (n_pts, 3))
    m = mapstate.empty_map(cap, dev)
    zeros_i = torch.zeros(n_pts, dtype=torch.int32, device=dev)
    for i in range(n_cams):
        R = torch.eye(3, device=dev)
        t = torch.tensor([0.2 * i, 0.0, 0.0], device=dev)
        m, ki = mapstate.add_keyframe(m, R, t, float(i), i)
        uv = cameras.pinhole_project(cam, lie.se3_apply(R, t, X))
        if i == 0:
            m, pt_idx = mapstate.add_points(
                m, X, torch.zeros((n_pts, 8), dtype=torch.int32, device=dev),
                torch.zeros((n_pts, 3), device=dev), torch.full((n_pts,), 0.1, device=dev),
                torch.full((n_pts,), 100.0, device=dev), ki, i,
                torch.ones(n_pts, dtype=torch.bool, device=dev))
        m = mapstate.add_observations(m, ki, pt_idx, uv, zeros_i,
                                      torch.ones(n_pts, dtype=torch.bool, device=dev))
    # perturb the points so that the BA has work to do
    m = m._replace(pt_xyz=m.pt_xyz + 0.01 * m.pt_valid[:, None].to(torch.float32))

    mesh = multihost.Mesh(n_devices)
    m2 = mapping.run_local_ba(m, n_cams - 1, "pinhole", cam, window=4, iterations=2, mesh=mesh,
                              cap_cams=8, cap_pts=cap.n_pt, cap_obs=cap.n_obs)
    assert bool(torch.isfinite(m2.kf_t[:n_cams]).all()), \
        "sharded pipeline BA produced non-finite poses"

    # the two cross-process schemes of dist_ba: "dense" (2 collectives per
    # LM iteration) and "camshard" (keyframe-block-sharded reduced system);
    # the cameras must divide the mesh for camshard
    n_cams_cs = max(n_devices, 4)
    O_cap = max(64 * n_devices, 256)
    Xc = normal(1, (n_pts, 3))
    Rc = torch.eye(3, device=dev).expand(n_cams_cs, 3, 3).contiguous()
    tc = torch.from_numpy(np.stack([np.linspace(0, 1, n_cams_cs), np.zeros(n_cams_cs),
                                    np.zeros(n_cams_cs)], 1).astype(np.float32)).to(dev)
    oc = torch.arange(O_cap, device=dev) % n_cams_cs
    op = torch.arange(O_cap, device=dev) % n_pts
    uv = cameras.pinhole_project(cam, lie.se3_apply(Rc[oc], tc[oc], Xc[op]))
    prob = ba_mod.BAProblem(
        R=Rc, t=tc, cam_fixed=torch.arange(n_cams_cs, device=dev) == 0,
        cam_valid=torch.ones(n_cams_cs, dtype=torch.bool, device=dev),
        X=Xc + 0.01, pt_valid=torch.ones(n_pts, dtype=torch.bool, device=dev),
        obs_cam=oc.to(torch.int32), obs_pt=op.to(torch.int32), obs_uv=uv,
        obs_inv_sigma2=torch.ones(O_cap, device=dev),
        obs_valid=torch.ones(O_cap, dtype=torch.bool, device=dev))
    dprob = dist_ba.partition_problem(prob, n_devices)
    for comm in ("dense", "camshard"):
        _, t_o, _, _ = dist_ba.dist_bundle_adjust(dprob, mesh, cam_model="pinhole",
                                                  cam_params=cam, iterations=2, pcg_iters=6,
                                                  comm=comm)
        assert bool(torch.isfinite(t_o).all()), f"dist_ba comm={comm} produced non-finite poses"
