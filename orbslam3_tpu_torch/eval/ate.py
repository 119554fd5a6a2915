"""ATE evaluation: association + Horn alignment with scale.

The port of `orbslam3_tpu/eval/ate.py`, a standalone re-implementation of
the reference acceptance oracle (evaluation/evaluate_ate_scale.py +
associate.py): associate the estimated and the ground-truth trajectories by
timestamp, align them with Umeyama (rotation + translation + scale) and
report the translational RMSE.  Timestamps stay float64 on the host (EuRoC
stamps are ~1.4e9 s, 128 s per float32 ulp); the alignment runs in float32
on the CPU through `ops.align`, as the JAX package runs it in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import align


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (reference associate.py): each
    stamp of `ts_a` takes the nearest unused stamp of the sorted `ts_b`
    within `max_dt`."""
    pairs = []
    used_b = set()
    for i, ta in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, ta))
        best, best_dt = -1, max_dt
        for cand in (j - 1, j, j + 1):
            if 0 <= cand < len(ts_b) and cand not in used_b:
                dt = abs(ts_b[cand] - ta)
                if dt < best_dt:
                    best, best_dt = cand, dt
        if best >= 0:
            pairs.append((i, best))
            used_b.add(best)
    return pairs


def evaluate_ate(est_ts: np.ndarray, est_xyz: np.ndarray,
                 gt_ts: np.ndarray, gt_xyz: np.ndarray,
                 max_dt: float = 0.02, with_scale: bool = True) -> dict:
    """Returns dict(rmse, mean, median, scale, n_pairs)."""
    pairs = associate(est_ts, gt_ts, max_dt)
    if len(pairs) < 3:
        return dict(rmse=float("inf"), mean=float("inf"),
                    median=float("inf"), scale=0.0, n_pairs=len(pairs))
    ei = np.asarray([p[0] for p in pairs])
    gi = np.asarray([p[1] for p in pairs])
    e = torch.as_tensor(np.asarray(est_xyz)[ei], dtype=torch.float32)
    g = torch.as_tensor(np.asarray(gt_xyz)[gi], dtype=torch.float32)
    R, t, s = align.umeyama_alignment(e, g, with_scale=with_scale)
    ea = (s * e) @ R.T + t
    err = torch.linalg.norm(ea - g, dim=-1).numpy()
    return dict(rmse=float(np.sqrt(np.mean(err ** 2))),
                mean=float(err.mean()), median=float(np.median(err)),
                scale=float(s), n_pairs=len(pairs))
