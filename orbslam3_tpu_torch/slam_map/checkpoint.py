"""Map checkpoint and resume (atlas save and load).

Counterpart of `orbslam3_tpu/slam_map/checkpoint.py` (parity target:
upstream ORB-SLAM3 V1.0's atlas save / load, which the fork removed; its
serialization fields remain in include/KeyFrame.h:304-330).  The file layout
is the JAX package's, in both directions:

  * `path` is an `.npz` with one array per map field, named `map__<field>`;
  * `path + ".extras.pkl"` is a pickle of numpy arrays and Python values:
    `ff_<k>` (a keyframe's FeatureFrame fields) and `bind_<k>` (its
    keypoint -> point bindings) for every keyframe that is not culled,
    `ur_<k>` (stereo right-u rows, written for the stereo Systems),
    `R_cur`, `t_cur`, `frame_id`, `last_kf_id`, and for an inertial System
    `inertial` (bias, velocity, the initialization flags, the
    preintegration chain's keyframe pairs and raw buffers, the IMU queues).

Descriptors are uint32 on disk and int32 bit patterns in the port.  The port
keeps a keyframe's features in its feature bank, which has no `response`
row: `save_system` writes zeros there (nothing reads it after a restore).
`load_system` reads only numpy and pickle, so it loads a file that the JAX
package wrote; the pickle is trusted input, as in JAX.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import convert
from . import state as mapstate

_UINT32 = ("pt_desc", "pt_desc_hist")   # map fields that JAX keeps as uint32


def _map_arrays(m: mapstate.MapState) -> dict:
    out = {}
    for k, v in m._asdict().items():
        a = v.detach().cpu().numpy()
        out[f"map__{k}"] = a.view(np.uint32) if k in _UINT32 else a
    return out


def _write_npz(path: str, arrays: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def save_map(path: str, m: mapstate.MapState) -> None:
    """Save the map to `path` (.npz)."""
    _write_npz(path, _map_arrays(m))


def _load_fields(path: str) -> dict:
    """The map fields of a checkpoint as numpy; `pt_kf_mask`, absent from
    files written before it existed, is derived from the observations."""
    with np.load(path, allow_pickle=False) as z:
        fields = {name: z[f"map__{name}"] for name in mapstate.MapState._fields
                  if f"map__{name}" in z}
    missing = [n for n in mapstate.MapState._fields if n not in fields]
    if missing and missing != ["pt_kf_mask"]:
        raise KeyError(f"checkpoint missing non-derivable fields {missing}")
    return fields


def load_map(path: str, device="cpu") -> mapstate.MapState:
    """Load a MapState saved by `save_map` (by either package) onto `device`."""
    fields = _load_fields(path)
    if "pt_kf_mask" in fields:
        return convert.map_from_numpy(fields, device)
    fields["pt_kf_mask"] = np.zeros((fields["pt_xyz"].shape[0], fields["kf_R"].shape[0]), bool)
    return mapstate.rebuild_incidence(convert.map_from_numpy(fields, device))


def save_system(path: str, system) -> None:
    """Checkpoint a System: the map, every keyframe's features and bindings
    from the bank, the tracker pose and frame counters, and for an inertial
    System the IMU tracker state with the preintegration chain's raw buffers
    (factors are replayed from them at restore, as the reference's
    KeyFrame serialization backups allow, include/KeyFrame.h:304-330)."""
    extras = {}
    m = system.map
    nk = system.n_kf_host
    # the stereo right-u rows of a stereo System (JAX keeps them in kf_ur)
    stereo = system.cfg.stereo_bf > 0.0 or hasattr(system, "scfg")
    if system.bank is not None and nk:
        valid = m.kf_valid[:nk].cpu().numpy()
        rows = {k: v[:nk].cpu().numpy() for k, v in system.bank._asdict().items()}
        for k in np.nonzero(valid)[0].tolist():
            extras[f"ff_{k}"] = dict(
                xy=rows["xy"][k], response=np.zeros(rows["xy"].shape[1], np.float32),
                octave=rows["octave"][k], angle=rows["angle"][k],
                desc=rows["desc"][k].view(np.uint32), valid=rows["valid"][k])
            extras[f"bind_{k}"] = rows["kp_pt"][k]
            if stereo:
                extras[f"ur_{k}"] = rows["ur"][k]
    R_cw, t_cw = system._pose_numpy()
    extras["R_cur"] = np.array(R_cw, np.float32)
    extras["t_cur"] = np.array(t_cw, np.float32)
    # frame counters: a restored session that restarted at frame 0 against a
    # map stamped with large kf_frame_id / pt_first_frame values would see
    # negative point-culling ages
    extras["frame_id"] = int(system.frame_id)
    extras["last_kf_id"] = int(system.last_kf_id)
    if hasattr(system, "preint_raw"):      # InertialSystem
        extras["inertial"] = {
            "bias": system.bias.cpu().numpy(), "vel": system.vel.cpu().numpy(),
            "imu_initialized": bool(system.imu_initialized),
            "viba1_done": bool(system.viba1_done), "viba2_done": bool(system.viba2_done),
            "kf_time0": system.kf_time0, "last_frame_ts": system.last_frame_ts,
            "preint_kf_pairs": list(system.preint_kf_pairs),
            "preint_raw": [tuple(np.asarray(x) for x in r) for r in system.preint_raw],
            "kf_imu_buffer": [(float(t), np.asarray(g), np.asarray(a))
                              for (t, g, a) in system.kf_imu_buffer],
            "imu_queue": [(float(t), np.asarray(g), np.asarray(a))
                          for (t, g, a) in system.imu_queue],
        }
    _write_npz(path, _map_arrays(m))
    with open(path + ".extras.pkl", "wb") as f:
        pickle.dump(extras, f)


def load_system(path: str, system) -> None:
    """Restore a System checkpoint (written by either package) in place."""
    fields = _load_fields(path)
    system.map = load_map(path, system.device)
    with open(path + ".extras.pkl", "rb") as f:
        extras = pickle.load(f)
    frames = {int(k[3:]): v for k, v in extras.items() if k.startswith("ff_")}
    binds = {int(k[5:]): v for k, v in extras.items() if k.startswith("bind_")}
    ur = {int(k[3:]): v for k, v in extras.items() if k.startswith("ur_")}
    dev = system.device
    R = torch.from_numpy(np.array(extras["R_cur"], np.float32)).to(dev)
    t = torch.from_numpy(np.array(extras["t_cur"], np.float32)).to(dev)
    system._set_pose(R, t)
    system.R_prev, system.t_prev = R, t
    system.has_velocity = False
    system.frame_id = int(extras.get("frame_id", system.frame_id))
    system.last_kf_id = int(extras.get("last_kf_id", system.last_kf_id))
    # the host mirrors, from the file (keyframe insertion trusts them: a
    # stale count would overwrite live keyframe slots)
    nk = int(fields["n_kf"])
    system.n_kf_host = nk
    system.last_kf_idx = nk - 1
    system.last_kf_ts = float(fields["kf_ts"][nk - 1]) if nk else 0.0
    system._prev_frame_ts = None
    if nk >= 2:
        from ..pipeline.system import OK
        system.state = OK
    # the feature bank from the keyframes' features and bindings
    system.bank = convert.bank_from_frames(fields["kf_R"].shape[0], frames, binds, dev, ur)
    # the place-recognition database re-encoded (reference LoadAtlas
    # re-encodes every keyframe's BoW; without it a restored session can
    # neither relocalize nor close a loop against the loaded map)
    if system.loop_closer is not None:
        from ..place import keyframe_db as kdb
        lc = system.loop_closer
        lc.db = kdb.clear(lc.db)
        lc.consistent_groups = []
        for k in sorted(frames):
            lc.add_keyframe(system.map, k, convert.frame_from_numpy(frames[k], dev))
    # the inertial tracker state and the preintegration chain, replayed from
    # the raw buffers at the restored bias: the session continues without a
    # new scale initialization
    iner = extras.get("inertial")
    if iner is not None and hasattr(system, "preint_raw"):
        system.bias = torch.from_numpy(np.array(iner["bias"], np.float32)).to(dev)
        system.vel = torch.from_numpy(np.array(iner["vel"], np.float32)).to(dev)
        for name in ("imu_initialized", "viba1_done", "viba2_done", "kf_time0",
                     "last_frame_ts"):
            setattr(system, name, iner[name])
        system.preint_kf_pairs = [tuple(p) for p in iner["preint_kf_pairs"]]
        system.preint_raw = [tuple(np.asarray(x) for x in r) for r in iner["preint_raw"]]
        system.preints = [system._preint_raw(a, g, d, system.bias)
                          for (a, g, d) in system.preint_raw]
        system.kf_imu_buffer = list(iner["kf_imu_buffer"])
        system.imu_queue = list(iner["imu_queue"])
        system.last_body = system._cam_to_body(system.R_cur, system.t_cur)
        system.frame_prior = None
        system._frame_rows = None
        system._map_updated = True
    # the bounded tracking view against the restored map
    if system.cfg.local_view_points > 0 and nk:
        system._refresh_view()
