"""The engine with its local BA sharded: `tests/test_engine_mesh.py`'s scene,
drive and gates, for the port's tests and `chip_smoke.py` phase 14b.

The monocular `System` on `synthetic_world`'s feature frames (`camera_path`,
42 frames, world seed 5) with `ba_caps` (16, 4096, 12288), once with
`ba_mesh_shards=8` (the window BA through `parallel.dist_ba` on eight
shards) and once on one device.  JAX's gates (test_engine_mesh.py:53-66):
both runs OK to the end with no reset and an ATE below 0.05, the two
trajectories within 0.02 of each other (ATE of one against the other over
more than 30 common frames), and the sharded run with at least 5 keyframes
and more than 300 points.

The single-device run takes the COO PCG solver (`coo_local_ba`), the one
the mesh path lowers to; JAX's own test leaves it to the grid solver that
`run_local_ba` picks without a mesh.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import align
from ..pipeline import mapping, system
from .synthetic_world import HW, K4, SyntheticWorld, camera_path

BASE = dict(cam_params=K4, image_hw=HW, min_init_matches=80, max_frames_between_kf=6,
            ba_caps=(16, 4096, 12288))
N_FRAMES = 42
SEED = 5


def config(**kw) -> system.SlamConfig:
    return system.SlamConfig(**{**BASE, **kw})


def coo_local_ba(cfg: system.SlamConfig, cam, m, center_kf, bank=None):
    """`system.local_ba` on one device through the COO PCG solver."""
    cams, pts, obs = cfg.ba_caps
    return mapping.run_local_ba(
        m, center_kf, cfg.cam_model, cam, window=cfg.local_ba_window,
        iterations=cfg.local_ba_iters, scale_factor=cfg.orb.scale_factor,
        n_levels=cfg.orb.n_levels, stereo_bf=cfg.stereo_bf, pcg_iters=cfg.ba_pcg_iters,
        schur_solver="pcg", bank=bank, cap_cams=cams, cap_pts=pts, cap_obs=obs)


@contextlib.contextmanager
def local_ba_as(fn):
    """Every window BA of the System (`system.local_ba`) replaced by `fn`."""
    orig = system.local_ba
    system.local_ba = fn
    try:
        yield
    finally:
        system.local_ba = orig


def run(cfg: system.SlamConfig, device, n_frames: int = N_FRAMES, seed: int = SEED,
        coo: bool = False):
    """Drive the System on the scene; returns (System, ATE, {ts: centre})."""
    world = SyntheticWorld(seed=seed)
    poses = camera_path(n_frames)
    sys_ = system.System(cfg, device=device)
    with local_ba_as(coo_local_ba) if coo else contextlib.nullcontext():
        for i, (R_cw, t_cw, _) in enumerate(poses):
            sys_.track_monocular(None, ts=i * 0.05, features=world.frame(R_cw, t_cw, device=device))
    est = np.stack([p[2] for p in sys_.trajectory]).astype(np.float32)
    ts_used = [p[0] for p in sys_.trajectory]
    gt = np.stack([poses[int(round(t / 0.05))][2] for t in ts_used]).astype(np.float32)
    rmse, _, _, _ = align.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt))
    return sys_, float(rmse), dict(zip(ts_used, est))


def gates(one, sharded) -> list[str]:
    """JAX's gates on the single-device and the sharded runs (each a `run`
    result); the failures, empty when all hold."""
    bad = []
    for name, (s_, rmse, _) in (("single device", one), ("sharded", sharded)):
        if s_.state != system.OK or s_.n_resets != 0 or not rmse < 0.05:
            bad.append(f"{name}: state {s_.state}, {s_.n_resets} resets, ATE {rmse}")
    n_common = len(set(one[2]) & set(sharded[2]))
    d = apart(one, sharded) if n_common > 30 else float("inf")
    if not d < 0.02:
        bad.append(f"the runs {d} apart over {n_common} common frames")
    s8 = sharded[0]
    n_pt = int(s8.map.pt_valid.sum())
    if s8.n_kf_host < 5 or n_pt <= 300:
        bad.append(f"sharded: {s8.n_kf_host} keyframes, {n_pt} points")
    return bad


def apart(one, sharded) -> float:
    """ATE of the sharded run's centres against the single-device run's."""
    common = sorted(set(one[2]) & set(sharded[2]))
    a = np.stack([one[2][t] for t in common])
    b = np.stack([sharded[2][t] for t in common])
    return float(align.ate_rmse(torch.from_numpy(a), torch.from_numpy(b))[0])
