"""Atlas: the container of stored maps, filled when a map is archived on a
tracking loss or a timestamp anomaly, and the Sim3 weld of one map into
another.

Counterpart of `orbslam3_tpu/slam_map/atlas.py` (parity target: reference
Atlas, include/Atlas.h:42-128, src/Atlas.cc:47 CreateNewMap, which keeps the
old map, and upstream's map merge, which welds two maps after a cross-map
place-recognition hit).  Merging is a splice into the archived map's
fixed-capacity tensors after the newer map is carried by the measured Sim3
(x_old = s Rg x_new + tg).

A `MapSession` holds the map and its feature bank: the port keeps every
keyframe's features and bindings in the bank only, where the JAX `System`
also mirrors them in two host dictionaries.  So a merge also splices the
banks (`splice_banks`), the counterpart of JAX's dictionary remap and bank
rebuild (map_merging.py:100-130).  One difference follows: the bank holds
the bindings that a keyframe's insertion gives its neighbours' keypoints,
which JAX's dictionaries never received, so the spliced bank keeps them where
JAX's rebuilt one loses them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import feature_bank as fb
from . import state as mapstate
from .feature_bank import FeatureBank


@dataclasses.dataclass
class MapSession:
    """One stored map with its bank and trajectory (a 'Map' in the reference Atlas)."""
    map: mapstate.MapState
    bank: FeatureBank | None   # per-keyframe features, bindings, stereo rows
    trajectory: list
    db: object = None   # the map's place-recognition `KeyframeDB`, archived with it


@dataclasses.dataclass
class Atlas:
    capacity: mapstate.MapCapacity
    sessions: list = dataclasses.field(default_factory=list)

    def store_session(self, m, bank, trajectory, db=None):
        """Archive the current map if it has at least two keyframes."""
        if int(m.n_kf) >= 2:
            self.sessions.append(MapSession(map=m, bank=bank,
                                            trajectory=list(trajectory), db=db))

    @property
    def n_maps(self) -> int:
        return len(self.sessions)


def transform_map(m: mapstate.MapState, Rg, tg, s) -> mapstate.MapState:
    """Apply the world Sim3 x' = s Rg x + tg to every keyframe and point.
    Camera poses: R' = R Rg^T, t' = s t - R' tg (projections unchanged up
    to the global scale)."""
    kf_R = torch.einsum("kij,lj->kil", m.kf_R, Rg)
    kf_t = s * m.kf_t - torch.einsum("kij,j->ki", kf_R, tg)
    return m._replace(
        kf_R=kf_R, kf_t=kf_t, pt_xyz=s * torch.einsum("ij,kj->ki", Rg, m.pt_xyz) + tg,
        kf_vel=s * torch.einsum("ij,kj->ki", Rg, m.kf_vel),
        pt_normal=torch.einsum("ij,kj->ki", Rg, m.pt_normal),
        pt_min_dist=m.pt_min_dist * s, pt_max_dist=m.pt_max_dist * s)


def _splice(a: torch.Tensor, b: torch.Tensor, n_a: int, n_b: int) -> torch.Tensor:
    """a with rows [n_a, n_a + n_b) replaced by b's first n_b rows (static
    host slices: no index is dropped and none is written twice)."""
    out = a.clone()
    out[n_a:n_a + n_b] = b[:n_b]
    return out


def merge_maps(m_old: mapstate.MapState, m_new: mapstate.MapState, Rg, tg, s,
               cap: mapstate.MapCapacity
               ) -> tuple[Optional[mapstate.MapState], int, int]:
    """Weld m_new into m_old's frame (x_old = s Rg x_new + tg).

    Returns (merged map, kf_offset, pt_offset), new-map indices shifted by
    the offsets, or (None, 0, 0) if a capacity would overflow.  The counters
    of both maps are read in one transfer."""
    counts = torch.stack([m_old.n_kf, m_old.n_pt, m_old.n_obs, m_old.n_loop,
                          m_new.n_kf, m_new.n_pt, m_new.n_obs, m_new.n_loop]).tolist()
    nk_o, np_o, no_o, nl_o, nk_n, np_n, no_n, nl_n = counts
    if nk_o + nk_n > cap.n_kf or np_o + np_n > cap.n_pt or no_o + no_n > cap.n_obs:
        return None, 0, 0
    t = transform_map(m_new, Rg, tg, s)
    dev = m_old.kf_R.device

    def counter(n):
        return torch.full((), n, dtype=torch.int32, device=dev)

    def kf(name):
        return _splice(getattr(m_old, name), getattr(t, name), nk_o, nk_n)

    def pt(name):
        return _splice(getattr(m_old, name), getattr(t, name), np_o, np_n)

    def ob(name):
        return _splice(getattr(m_old, name), getattr(t, name), no_o, no_n)

    m = m_old._replace(
        **{f: kf(f) for f in ("kf_R", "kf_t", "kf_vel", "kf_bias", "kf_ts", "kf_frame_id",
                              "kf_valid")},
        **{f: pt(f) for f in ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist",
                              "pt_found", "pt_visible", "pt_first_frame", "pt_valid",
                              "pt_desc_hist", "pt_desc_n")},
        pt_ref_kf=_splice(m_old.pt_ref_kf, t.pt_ref_kf + nk_o, np_o, np_n),
        **{f: ob(f) for f in ("obs_uv", "obs_octave", "obs_ur", "obs_valid")},
        obs_kf=_splice(m_old.obs_kf, t.obs_kf + nk_o, no_o, no_n),
        obs_pt=_splice(m_old.obs_pt, t.obs_pt + np_o, no_o, no_n),
        n_kf=counter(nk_o + nk_n), n_pt=counter(np_o + np_n), n_obs=counter(no_o + no_n))
    # the incoming map's persistent loop edges ride along with shifted
    # keyframe indices (the reference merge keeps every keyframe's loop edges)
    if nl_n and nl_o + nl_n <= m.loop_i.shape[0]:
        m = m._replace(
            loop_i=_splice(m.loop_i, m_new.loop_i + nk_o, nl_o, nl_n),
            loop_j=_splice(m.loop_j, m_new.loop_j + nk_o, nl_o, nl_n),
            loop_R=_splice(m.loop_R, m_new.loop_R, nl_o, nl_n),
            # camera-frame relative translations scale with the weld
            # (x_cam' = s x_cam under transform_map)
            loop_t=_splice(m.loop_t, m_new.loop_t * s, nl_o, nl_n),
            loop_s=_splice(m.loop_s, m_new.loop_s, nl_o, nl_n),
            loop_valid=_splice(m.loop_valid, m_new.loop_valid, nl_o, nl_n),
            n_loop=counter(nl_o + nl_n))
    # the splice bypassed add_observations: recompute the incidence
    return mapstate.rebuild_incidence(m), nk_o, np_o


def splice_banks(bank_old: FeatureBank, bank_new: FeatureBank, kf_valid: torch.Tensor,
                 nk_o: int, nk_n: int, pt_off: int) -> FeatureBank:
    """The merged map's bank: the archived bank's rows [0, nk_o), then the
    current bank's rows [0, nk_n) at nk_o with their bindings shifted by
    `pt_off` where bound.  The rows of keyframes that are not valid in the
    merged map (culled ones; `kf_valid` is the merged map's) are emptied, as
    JAX's rebuild from its dictionaries, which drop a culled keyframe, leaves
    them."""
    K, N = bank_old.xy.shape[:2]
    empty = fb.empty_bank(K, N, bank_old.xy.device)
    kp_new = torch.where(bank_new.kp_pt >= 0, bank_new.kp_pt + pt_off, -1)
    out = []
    for name, e in zip(FeatureBank._fields, empty):
        a = _splice(e, getattr(bank_old, name), 0, nk_o)
        a = _splice(a, kp_new if name == "kp_pt" else getattr(bank_new, name), nk_o, nk_n)
        keep = kf_valid.reshape((K,) + (1,) * (a.dim() - 1))
        out.append(torch.where(keep, a, e))
    return FeatureBank(*out)
