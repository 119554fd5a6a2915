"""A synthetic bundle-adjustment problem for the sharded BA on the card.

The structure of the JAX package's `tests/test_dist_ba.py::synth_problem`
(points ahead of a row of cameras 0.3 apart along x, the cameras' poses
moved by 0.02 from the row and then perturbed by 0.01, cameras 0 and 1
fixed, the points perturbed by 0.05, exact observations) at any size: there
every camera sees every point and the observation capacity cuts the list,
which at `chip_smoke.py` phase 14a's size (32 cameras, 16,384 points,
65,536 observations, bench_multihost's width at 8 shards) would leave most
points unseen.  Here each point is seen by `n_obs / n_pts` distinct
cameras drawn at random.  NumPy draws from `seed`; float32 tensors on
`device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cameras, lie
from ..solver import ba

K4 = (458.654, 457.296, 367.215, 248.375)


def problem(n_cams: int = 32, n_pts: int = 16384, n_obs: int = 65536, seed: int = 0,
            device="cpu"):
    """(BAProblem, (R, t, X) truth)."""
    assert n_obs % n_pts == 0 and n_obs // n_pts <= n_cams
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))   # noqa: E731
    X = f32(rng.normal(size=(n_pts, 3)) * [2.0, 2.0, 1.0] + [0.0, 0.0, 6.0])
    dxi = 0.02 * rng.normal(size=(n_cams, 6))
    dxi[0] = 0.0
    R, t = lie.se3_exp(f32(dxi))
    t = t + f32(np.stack([0.3 * np.arange(n_cams), np.zeros(n_cams), np.zeros(n_cams)], 1))
    per = n_obs // n_pts
    obs_cam = np.argsort(rng.random((n_pts, n_cams)), axis=1)[:, :per].reshape(-1)
    obs_pt = np.repeat(np.arange(n_pts), per)
    ci, pi = torch.from_numpy(obs_cam), torch.from_numpy(obs_pt)
    uv = cameras.pinhole_project(torch.tensor(K4), lie.se3_apply(R[ci], t[ci], X[pi]))
    fixed = torch.zeros(n_cams, dtype=torch.bool)
    fixed[:2] = True
    dxi2 = 0.01 * rng.normal(size=(n_cams, 6))
    dxi2[:2] = 0.0
    dR, dt = lie.se3_exp(f32(dxi2))
    Rp, tp = lie.se3_compose(dR, dt, R, t)
    Xp = X + f32(0.05 * rng.normal(size=X.shape))
    on = lambda x: x.to(device)   # noqa: E731
    prob = ba.BAProblem(
        R=on(Rp), t=on(tp), cam_fixed=on(fixed), cam_valid=on(torch.ones(n_cams, dtype=torch.bool)),
        X=on(Xp), pt_valid=on(torch.ones(n_pts, dtype=torch.bool)),
        obs_cam=on(ci.to(torch.int32)), obs_pt=on(pi.to(torch.int32)), obs_uv=on(uv),
        obs_inv_sigma2=on(torch.ones(n_obs)), obs_valid=on(torch.ones(n_obs, dtype=torch.bool)))
    return prob, (on(R), on(t), on(X))
