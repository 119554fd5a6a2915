"""Device-resident per-keyframe feature bank.

Counterpart of `orbslam3_tpu/slam_map/feature_bank.py`: one stacked
tensor per field, so that neighbour selection, multi-neighbour
triangulation and the window BA's observation gather index keyframes on
the device instead of looking them up on the host.  The bank also carries
each keyframe's keypoint -> map-point bindings (reference
KeyFrame::mvpMapPoints).  Descriptors are int32 bit patterns, as
everywhere in the port.

`set_frame` and `set_binding` return a new bank and leave their input
untouched, as in JAX; the row index may be a Python int or a 0-d tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..features.extractor import FeatureFrame
from .state import _row, _set_at


class FeatureBank(NamedTuple):
    xy: torch.Tensor       # (K, N, 2) f32
    desc: torch.Tensor     # (K, N, 8) int32 bit patterns
    octave: torch.Tensor   # (K, N) int32
    angle: torch.Tensor    # (K, N) f32 degrees
    valid: torch.Tensor    # (K, N) bool
    kp_pt: torch.Tensor    # (K, N) int32 keypoint -> map point (-1 unbound)
    ur: torch.Tensor       # (K, N) f32 stereo right-u (-1 = mono)


def empty_bank(n_kf: int, n_kp: int, device="cpu") -> FeatureBank:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FeatureBank(
        xy=z(n_kf, n_kp, 2), desc=z(n_kf, n_kp, 8, dtype=torch.int32),
        octave=z(n_kf, n_kp, dtype=torch.int32), angle=z(n_kf, n_kp),
        valid=z(n_kf, n_kp, dtype=torch.bool),
        kp_pt=torch.full((n_kf, n_kp), -1, dtype=torch.int32, device=device),
        ur=torch.full((n_kf, n_kp), -1.0, dtype=torch.float32, device=device))


def set_frame(bank: FeatureBank, k, ff: FeatureFrame, kp_pt, ur=None) -> FeatureBank:
    """Write one keyframe's features and bindings at row k (dropped when k
    is past the end: a full map)."""
    if ur is None:
        ur = torch.full((ff.xy.shape[0],), -1.0, dtype=torch.float32,
                        device=ff.xy.device)
    return FeatureBank(
        xy=_set_at(bank.xy, k, ff.xy), desc=_set_at(bank.desc, k, ff.desc),
        octave=_set_at(bank.octave, k, ff.octave),
        angle=_set_at(bank.angle, k, ff.angle),
        valid=_set_at(bank.valid, k, ff.valid),
        kp_pt=_set_at(bank.kp_pt, k, kp_pt), ur=_set_at(bank.ur, k, ur))


def set_binding(bank: FeatureBank, k, kp_pt) -> FeatureBank:
    return bank._replace(kp_pt=_set_at(bank.kp_pt, k, kp_pt))


def frame_view(bank: FeatureBank, k) -> FeatureFrame:
    """One keyframe's features as a FeatureFrame."""
    return FeatureFrame(
        xy=_row(bank.xy, k), response=torch.zeros(bank.xy.shape[1], device=bank.xy.device),
        octave=_row(bank.octave, k), angle=_row(bank.angle, k), desc=_row(bank.desc, k),
        valid=_row(bank.valid, k))
