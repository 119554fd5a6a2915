"""Carry state between the JAX package and the port as numpy arrays.

numpy in, numpy out; nothing here imports JAX.  A test fills these from
`jax.device_get(x)._asdict()` so that both sides compute on the same map,
view, feature frame, stereo depth, feature bank, match set, two-view result,
keyframe database, codebook, preintegration, factor stack or frame prior;
`set_inertial_state` gives an `InertialSystem` the inertial bookkeeping of
another one; `bank_from_frames` and `session_from_numpy` turn the JAX
`System`'s per-keyframe host dictionaries (features, bindings, and a stereo
session's right-u rows) into the port's feature bank, the latter for a
whole Atlas session (map, bank, trajectory, database), and
`slam_map/checkpoint.py` rebuilds a restored bank with the former.  uint32 descriptor and codebook words cross as int32
bit patterns (`.view(np.int32)`), the port's descriptor format.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.extractor import FeatureFrame
from ..features.stereo import StereoDepth
from ..geometry.twoview import TwoViewResult
from ..ops.imu import Preintegrated
from ..ops.matching import Matches
from ..place.keyframe_db import KeyframeDB
from ..place.vocab import codebook_tensor as codebook_from_numpy  # (V, 8) uint32 -> int32
from ..solver.inertial import PreintFactor
from ..solver.vi_pose_opt import VIPosePrior
from . import feature_bank as fb
from .atlas import MapSession
from .feature_bank import FeatureBank
from .state import MapState, PointView


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _build(cls, fields: dict, device):
    return cls(**{k: _tensor(fields[k], device) for k in cls._fields})


def map_from_numpy(fields: dict, device="cpu") -> MapState:
    return _build(MapState, fields, device)


def view_from_numpy(fields: dict, device="cpu") -> PointView:
    return _build(PointView, fields, device)


def frame_from_numpy(fields: dict, device="cpu") -> FeatureFrame:
    return _build(FeatureFrame, fields, device)


def bank_from_numpy(fields: dict, device="cpu") -> FeatureBank:
    return _build(FeatureBank, fields, device)


def bank_from_frames(n_kf: int, frames: dict, bindings: dict, device="cpu",
                     ur: dict | None = None) -> FeatureBank | None:
    """The feature bank that the JAX `System` builds from its host
    dictionaries ({keyframe: FeatureFrame fields}, {keyframe: kp_pt}, and
    for stereo {keyframe: right-u}): a row for every keyframe with features
    and bindings (`System._bank_store`), the others empty; None when no
    keyframe has both."""
    rows = sorted(k for k in frames if k in bindings)
    if not rows:
        return None
    bank = {k: v.numpy() for k, v in fb.empty_bank(n_kf, len(frames[rows[0]]["xy"]))._asdict()
            .items()}
    for k in rows:
        f = frames[k]
        for name in ("xy", "desc", "octave", "angle", "valid"):
            bank[name][k] = np.asarray(f[name]).view(np.int32) if name == "desc" else f[name]
        bank["kp_pt"][k] = bindings[k]
        if ur is not None and k in ur:
            bank["ur"][k] = ur[k]
    return bank_from_numpy(bank, device)


def session_from_numpy(map_fields: dict, frames: dict, bindings: dict, trajectory: list,
                       db_fields: dict | None = None, device="cpu",
                       ur: dict | None = None) -> MapSession:
    """A JAX Atlas session (its map's fields, the `kf_features`,
    `kf_bindings` and, for a stereo session, `kf_ur` dictionaries as numpy,
    the trajectory and its keyframe database's fields) as the port's
    `MapSession`."""
    m = map_from_numpy(map_fields, device)
    return MapSession(
        map=m, bank=bank_from_frames(m.kf_R.shape[0], frames, bindings, device, ur),
        trajectory=[(ts, np.array(R), np.array(t)) for ts, R, t in trajectory],
        db=None if db_fields is None else db_from_numpy(db_fields, device))


def stereo_depth_from_numpy(fields: dict, device="cpu") -> StereoDepth:
    """A JAX `StereoDepth` (ur, depth, valid) as the port's."""
    return _build(StereoDepth, fields, device)


def matches_from_numpy(fields: dict, device="cpu") -> Matches:
    return _build(Matches, fields, device)


def twoview_from_numpy(fields: dict, device="cpu") -> TwoViewResult:
    return _build(TwoViewResult, fields, device)


def db_from_numpy(fields: dict, device="cpu") -> KeyframeDB:
    """A JAX `KeyframeDB`'s three arrays (tf, has_word, active) as the port's."""
    return _build(KeyframeDB, fields, device)


def preint_from_numpy(fields: dict, device="cpu") -> Preintegrated:
    return _build(Preintegrated, fields, device)


def factor_from_numpy(fields: dict, device="cpu") -> PreintFactor:
    return _build(PreintFactor, fields, device)


def prior_from_numpy(fields: dict, device="cpu") -> VIPosePrior:
    return _build(VIPosePrior, fields, device)


# the inertial bookkeeping of an InertialSystem beside the base System's state
INERTIAL_FLAGS = ("imu_initialized", "viba1_done", "viba2_done", "last_frame_ts", "kf_time0",
                  "_map_updated")


def set_inertial_state(sys_, state: dict) -> None:
    """Give `sys_` (an `InertialSystem`) the inertial state in `state`:
    the flags of INERTIAL_FLAGS; `imu_queue` and `kf_imu_buffer` as lists of
    (t, gyro, acc); `bias`, `vel` arrays; `last_body` None or (Rwb, pwb);
    `preints` a list of Preintegrated field dicts with `preint_kf_pairs` and
    `preint_raw` (numpy (acc, gyr, dts) per factor); `frame_prior` None or
    a VIPosePrior field dict; `frame_rows` None or packed rows."""
    dev = sys_.device
    for name in INERTIAL_FLAGS:
        setattr(sys_, name, state[name])
    sys_.imu_queue = list(state["imu_queue"])
    sys_.kf_imu_buffer = list(state["kf_imu_buffer"])
    sys_.bias = _tensor(state["bias"], dev)
    sys_.vel = _tensor(state["vel"], dev)
    lb = state["last_body"]
    sys_.last_body = None if lb is None else (_tensor(lb[0], dev), _tensor(lb[1], dev))
    sys_.preints = [preint_from_numpy(p, dev) for p in state["preints"]]
    sys_.preint_kf_pairs = [tuple(int(k) for k in p) for p in state["preint_kf_pairs"]]
    sys_.preint_raw = [tuple(np.array(a) for a in r) for r in state["preint_raw"]]
    fp = state["frame_prior"]
    sys_.frame_prior = None if fp is None else prior_from_numpy(fp, dev)
    fr = state["frame_rows"]
    sys_._frame_rows = None if fr is None else np.array(fr)


def to_numpy(x):
    """Tensor -> numpy array; NamedTuple of tensors -> dict of arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_asdict"):
        return {k: to_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)
