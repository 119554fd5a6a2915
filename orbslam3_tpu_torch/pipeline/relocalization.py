"""Relocalization: recover tracking after a loss through place recognition.

Counterpart of `orbslam3_tpu/pipeline/relocalization.py` (parity target:
upstream Tracking::Relocalization + KeyFrameDatabase::
DetectRelocalizationCandidates, src/KeyFrameDatabase.cc:731, + MLPnPsolver
RANSAC, src/MLPnPsolver.cpp; parameters at src/Tracking.cc:839).

Candidates come from the TF-IDF database; every admitted candidate (score >=
0.75 * best score, the reference's minScoreToRetain) is evaluated in one
batch of `RELOC_CANDS`: descriptor matching per candidate, with the features
gathered from the device feature bank, then one batched MLPnP RANSAC over all
of them.  An attempt reads back twice, as the JAX package does: the scores
(with the keyframes' validity, in one transfer) and, per batch, the decision
(success flags and inlier counts, in one transfer).  `torch.linalg.eigh` and
`svd` inside MLPnP add their own status reads on a CUDA device.

The JAX package admits a candidate only if the host dictionary
`kf_bindings` still has it.  The port keeps bindings in the bank, so the
equivalent here is that the keyframe is still registered in the database
(`db.active`, erased on keyframe culling: `query` scores an unregistered
keyframe -1, below any admission line) and still valid in the map
(`kf_valid`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import mlpnp
from ..ops import matching
from ..place import keyframe_db as kdb

RELOC_CANDS = 8       # fixed batch width (the reference retains a handful)
RELOC_ITERATIONS = 300
RELOC_SAMPLE = 6


def _reloc_batch(m, bank, ff, cand_idx, cand_ok, cam_params, cam_model: str,
                 scale_factor, n_levels: int, min_inliers: int,
                 idx: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
    """Match and MLPnP-score all admitted candidates at once.

    cand_idx (C,) keyframe indices, cand_ok (C,) bool; `idx`: (C, 300, 6)
    sample indices, drawn with `generator` when absent.  Returns (good (C,),
    n_inliers (C,), R (C, 3, 3), t (C, 3))."""
    P = m.pt_xyz.shape[0]
    K = bank.desc.shape[0]
    sf = scale_factor ** torch.clamp(ff.octave, 0, n_levels - 1).to(torch.float32)
    inv_s2 = 1.0 / (sf * sf)
    ci = torch.clamp(cand_idx, 0, K - 1).long()
    c_kp_pt = bank.kp_pt[ci]                                      # (C, N)
    c_valid, c_desc, c_angle = bank.valid[ci], bank.desc[ci], bank.angle[ci]
    mms = [matching.match_nn(
        ff.desc, c_desc[k],
        mask=ff.valid[:, None] & c_valid[k][None, :] & (c_kp_pt[k] >= 0)[None, :],
        max_dist=matching.TH_LOW, nn_ratio=0.75, angles_a=ff.angle,
        angles_b=c_angle[k], check_rotation=True)
        for k in range(cand_idx.shape[0])]
    mm_valid = torch.stack([mm.valid for mm in mms])             # (C, N)
    mm_idx = torch.stack([mm.idx for mm in mms])
    n_matches = torch.sum(mm_valid.to(torch.int32), dim=1)
    pt_idx = torch.clamp(torch.gather(c_kp_pt, 1, torch.clamp_min(mm_idx, 0).long()),
                         0, P - 1).long()
    X = m.pt_xyz[pt_idx]                                          # (C, N, 3)
    # culling or fusion may have invalidated a bound point since the
    # candidate keyframe was inserted: never solve against dead points
    match_ok = mm_valid & m.pt_valid[pt_idx] & cand_ok[:, None]
    res = mlpnp.solve_mlpnp(
        X, ff.xy, match_ok, cam_model, cam_params, idx=idx, generator=generator,
        iterations=RELOC_ITERATIONS, sample=RELOC_SAMPLE, min_inliers=min_inliers,
        inv_sigma2=inv_s2)
    good = res.success & (n_matches >= 15) & cand_ok
    return good, res.n_inliers, res.R, res.t


def admitted_candidates(scores: np.ndarray, kf_valid: np.ndarray) -> list[int]:
    """Keyframes scoring >= 0.75 * the best score (reference
    DetectRelocalizationCandidates minScoreToRetain: with aliased places the
    true candidate can sit well below rank 3), the best first, that are still
    valid in the map.  Empty when nothing scores above 0."""
    order = np.argsort(-scores)
    best = float(scores[order[0]])
    if best <= 0:
        return []
    return [int(c) for c in order if scores[c] >= 0.75 * best and kf_valid[c]]


def attempt_relocalization(system, ff, loop_closer, min_inliers: int = 30,
                           idx_fn=None):
    """Try to relocalize `ff` against the keyframe database.

    Returns (success, R, t).  Mutates nothing but the system's generator,
    which draws each batch's samples unless `idx_fn(lo, cand_idx, cand_ok)`
    gives the (RELOC_CANDS, 300, 6) indices of the batch that starts at
    candidate `lo` (the parity tests inject the JAX package's draw there).
    """
    m = system.map
    if system.bank is None:
        return False, None, None
    bow, _ = loop_closer._bow(ff.desc, ff.valid)
    scores, _ = kdb.query(loop_closer.db, bow)
    # read 1: the admission scores, with the keyframes' validity
    K = scores.shape[0]
    host = torch.cat([scores, m.kf_valid.to(torch.float32)]).cpu().numpy()
    cand_list = admitted_candidates(host[:K], host[K:] > 0)
    C = RELOC_CANDS
    dev = scores.device
    # batches of RELOC_CANDS, best-scored first; one batch and one decision
    # read per batch, and almost every call needs exactly one batch
    for lo in range(0, len(cand_list), C):
        batch = cand_list[lo:lo + C]
        cand = torch.from_numpy(np.array(batch + [-1] * (C - len(batch)), np.int32)).to(dev)
        cand_idx, cand_ok = torch.clamp_min(cand, 0), cand >= 0
        good, n_inl, R_all, t_all = _reloc_batch(
            m, system.bank, ff, cand_idx, cand_ok, system.cam_params,
            system.cfg.cam_model, system.cfg.orb.scale_factor,
            system.cfg.orb.n_levels, min_inliers,
            idx=None if idx_fn is None else idx_fn(lo, cand_idx, cand_ok),
            generator=system.generator)
        # read 2: the winner decision (one small transfer for the whole batch)
        good_np, n_np = torch.stack([good.to(torch.int32), n_inl.to(torch.int32)]).cpu().numpy()
        if good_np.any():
            w = int(np.argmax(np.where(good_np > 0, n_np, -1)))
            return True, R_all[w], t_all[w]
    return False, None, None
