"""Carry state between the JAX package and the port as numpy arrays.

numpy in, numpy out; nothing here imports JAX.  A test fills these from
`jax.device_get(x)._asdict()` so that both sides compute on the same map,
view, feature frame, feature bank, match set or two-view result.  uint32 descriptor words cross as int32 bit
patterns (`.view(np.int32)`), the port's descriptor format.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.extractor import FeatureFrame
from ..geometry.twoview import TwoViewResult
from ..ops.matching import Matches
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


def matches_from_numpy(fields: dict, device="cpu") -> Matches:
    return _build(Matches, fields, device)


def twoview_from_numpy(fields: dict, device="cpu") -> TwoViewResult:
    return _build(TwoViewResult, fields, device)


def to_numpy(x):
    """Tensor -> numpy array; NamedTuple of tensors -> dict of arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_asdict"):
        return {k: to_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)
