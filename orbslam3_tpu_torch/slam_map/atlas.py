"""Atlas: the container of stored maps, filled when a map is archived on a
tracking loss or a timestamp anomaly.

Counterpart of `MapSession`, `Atlas.store_session` and `n_maps` of
`orbslam3_tpu/slam_map/atlas.py` (parity target: reference Atlas,
include/Atlas.h:42-128, src/Atlas.cc:47 CreateNewMap, which keeps the old
map).  Transforming and merging stored maps belongs to map merging
(ROADMAP queue 1 item 5) and is not ported yet.

A `MapSession` holds the map and its feature bank: the port keeps every
keyframe's features and bindings in the bank only, where the JAX `System`
also mirrors them in two host dictionaries.
"""

from __future__ import annotations

import dataclasses

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
