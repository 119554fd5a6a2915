"""A drifted revisit for loop closing, built straight into a port `System`.

The scene of the JAX package's `tests/test_loop_integration.py`
(test_detect_and_correct_drifted_revisit): one place of 200 landmarks in
front of the origin, seen by keyframe 0; 14 keyframes exploring elsewhere,
each with 60 landmarks of its own; then a revisit keyframe that is back at
the origin but whose world has drifted by scale 1.12 and offset
(0.6, -0.3, 0.2): its 150 points are new duplicates of the place's first 150
in the drifted world, seen at the same pixels with the same descriptors.
A loop closure must bring the revisit keyframe's centre back to the origin
and its duplicates onto the originals.

`build` writes the scene into a `System`'s map and feature bank at the
System's capacity, with feature frames of `n_kp` keypoint slots (the JAX
test uses 256; the card's phase the default extractor's 1200), on the
System's device; `add_keyframe` and `place` are the pieces the JAX test's
other scenes are made of.  NumPy and torch only: the numbers are drawn with
NumPy as the JAX test draws them, so both packages can build the same scene.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..features.extractor import FeatureFrame
from ..ops import cameras
from ..pipeline import loop_closing
from ..slam_map import feature_bank as fb
from ..slam_map import state as mapstate
from ..slam_map.state import _upload

K4 = (458.654, 457.296, 367.215, 248.375)
N_PLACE = 200          # landmarks of the revisited place
N_MID = 14             # exploring keyframes between the visits
N_MID_PTS = 60         # landmarks of each exploring keyframe
N_DUP = 150            # of the place's landmarks, those the revisit duplicates
DRIFT_SCALE = 1.12
DRIFT_OFFSET = (0.6, -0.3, 0.2)


class Revisit(NamedTuple):
    ff: FeatureFrame       # the revisit keyframe's features
    kr: int                # its keyframe index
    pt_dup: torch.Tensor   # (N_DUP,) its duplicate points' slots
    X0: np.ndarray         # (N_PLACE, 3) the place's true landmarks


def make_frame(xy: np.ndarray, desc: np.ndarray, n_kp: int, device) -> FeatureFrame:
    """A FeatureFrame of `n_kp` slots holding the given keypoints first:
    octave 0, angle 0, the rest invalid."""
    n = xy.shape[0]
    pad = n_kp - n
    dev = torch.device(device)
    return FeatureFrame(
        xy=_upload(np.concatenate([xy, np.zeros((pad, 2))]).astype(np.float32), dev),
        response=torch.ones(n_kp, device=dev),
        octave=torch.zeros(n_kp, dtype=torch.int32, device=dev),
        angle=torch.zeros(n_kp, device=dev),
        desc=_upload(np.concatenate([desc, np.zeros((pad, 8), np.uint32)]).view(np.int32), dev),
        valid=torch.arange(n_kp, device=dev) < n)


def place(rng: np.random.Generator, n: int, x_off: float = 0.0):
    """n landmarks in a box in front of x = x_off and their descriptors
    (the JAX test's draws)."""
    X = np.stack([rng.uniform(-3, 3, n) + x_off, rng.uniform(-2, 2, n),
                  rng.uniform(4, 9, n)], 1).astype(np.float32)
    return X, rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def project(X: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Pixels of world points X under the camera (R, t), in float32."""
    Xc = torch.from_numpy(np.asarray(X, np.float32) @ np.asarray(R, np.float32).T +
                          np.asarray(t, np.float32))
    return cameras.pinhole_project(torch.tensor(K4), Xc).numpy()


def add_keyframe(sys_, k: int, X: np.ndarray, desc: np.ndarray, R, t, max_dist: float,
                 n_kp: int, uv: np.ndarray | None = None):
    """Append keyframe k at (R, t) with new points X (reference keyframe k,
    created at frame k, scale range [1, max_dist]) observed at octave 0 at
    `uv` (their projections by default); store its features and bindings in
    the bank.  Returns (keyframe index, point slots (n,), FeatureFrame)."""
    dev = sys_.device
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    n = X.shape[0]
    if uv is None:
        uv = project(X, R, t)
    ki = int(k)          # appended in order: the map's n_kf
    m, _ = mapstate.add_keyframe(sys_.map, _upload(R, dev), _upload(t, dev), float(k), k)
    m, pt = mapstate.add_points(
        m, _upload(X, dev), _upload(desc.view(np.int32), dev),
        _upload(np.array([0.0, 0.0, 1.0], np.float32), dev).expand(n, 3),
        torch.full((n,), 1.0, device=dev), torch.full((n,), max_dist, device=dev),
        ki, k, torch.ones(n, dtype=torch.bool, device=dev))
    m = mapstate.add_observations(m, ki, pt, _upload(uv.astype(np.float32), dev),
                                  torch.zeros(n, dtype=torch.int32, device=dev),
                                  torch.ones(n, dtype=torch.bool, device=dev))
    ff = make_frame(uv, desc, n_kp, dev)
    binding = torch.cat([pt, torch.full((n_kp - n,), -1, dtype=torch.int32, device=dev)])
    sys_.map = m
    sys_._bank_store(ki, ff, binding)
    sys_.n_kf_host = ki + 1
    return ki, pt, ff


def build(sys_, n_kp: int = 256, seed: int = 0) -> Revisit:
    """Write the drifted-revisit scene into `sys_` (an empty System) and
    leave its tracker at the revisit keyframe."""
    rng = np.random.default_rng(seed)
    X0, desc0 = place(rng, N_PLACE)
    eye = np.eye(3, dtype=np.float32)
    uv0 = project(X0, eye, np.zeros(3, np.float32))
    add_keyframe(sys_, 0, X0, desc0, eye, np.zeros(3), 30.0, n_kp, uv=uv0)
    for k in range(1, N_MID + 1):
        Xk, dk = place(rng, N_MID_PTS, 10.0 * k)
        add_keyframe(sys_, k, Xk, dk, eye, np.array([-10.0 * k, 0, 0]), 30.0, n_kp)
    # the drifted world x' = s x + d: the revisit camera (I, -d) sees the
    # duplicates at the place's pixels (camera coordinates scaled by s)
    offset = np.asarray(DRIFT_OFFSET, np.float32)
    X_dup = (DRIFT_SCALE * X0[:N_DUP] + offset).astype(np.float32)
    kr = N_MID + 1
    _, pt_dup, ff = add_keyframe(sys_, kr, X_dup, desc0[:N_DUP].copy(), eye, -offset, 40.0,
                                 n_kp, uv=uv0[:N_DUP])
    sys_._set_pose(sys_.map.kf_R[kr], sys_.map.kf_t[kr])
    sys_.R_prev, sys_.t_prev = sys_.R_cur, sys_.t_cur
    sys_.last_kf_idx = kr
    return Revisit(ff=ff, kr=kr, pt_dup=pt_dup, X0=X0)


def reprojections(m: mapstate.MapState):
    """(pixels, measured pixels) of every valid observation of the map
    (keyframe and point valid), its point projected by its keyframe's pose
    (the mask is read on the host).  The projections are what a bundle adjuster
    determines: a keyframe and the points that only it observes can move
    together in a similarity without changing them, as the exploring
    keyframes of this scene can in a GBA."""
    K, P = m.kf_R.shape[0], m.pt_xyz.shape[0]
    kf = torch.clamp(m.obs_kf, 0, K - 1).long()
    pt = torch.clamp(m.obs_pt, 0, P - 1).long()
    ok = m.obs_valid & m.pt_valid[pt] & m.kf_valid[kf]
    Xc = torch.einsum("nij,nj->ni", m.kf_R[kf], m.pt_xyz[pt]) + m.kf_t[kf]
    uv = cameras.pinhole_project(torch.tensor(K4, device=Xc.device), Xc)
    return uv[ok], m.obs_uv[ok]


def fixed_samples(kf_idx: int, valid: torch.Tensor, iterations: int = 128) -> torch.Tensor:
    """(iterations, 3) Sim3 sample indices over the matches `valid`, drawn
    with numpy from seed `kf_idx`: the same on every device, for
    `LoopCloser.try_close(idx_fn=fixed_samples)` (one read of `valid`)."""
    ok = np.nonzero(valid.cpu().numpy())[0]
    idx = np.random.default_rng(kf_idx).choice(ok, (iterations, 3))
    return _upload(idx.astype(np.int64), valid.device)


def loop_closer(sys_, upto: int) -> loop_closing.LoopCloser:
    """The JAX test's LoopCloser (every candidate accepted at once:
    `consistency_needed=0`, `min_kf_gap=5`) with keyframes 0..upto-1
    registered in its database from the bank."""
    lc = loop_closing.LoopCloser(loop_closing.LoopConfig(consistency_needed=0, min_kf_gap=5),
                                 sys_.cfg.map_capacity.n_kf, sys_.device)
    for k in range(upto):
        lc.add_keyframe(sys_.map, k, fb.frame_view(sys_.bank, k))
    return lc
