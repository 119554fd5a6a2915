"""Map state as fixed-capacity SoA tensors.

Counterpart of `orbslam3_tpu/slam_map/state.py` for what tracking and the
keyframe step need: the containers, the append ops, the incidence and
covisibility queries, the local view, point culling and slot compaction.

Functions return a new MapState (as in JAX) and leave their input
untouched.  Descriptors are int32 bit patterns (see `ops/brief.py`);
counters (`n_kf`, `n_pt`, `n_obs`) are 0-d int32 tensors so that no op
reads a value back to the host.

Scatters with JAX's `mode="drop"` (an out-of-range index drops the write)
go through `_set_drop`: the destination index n means "drop" and lands on
a scratch row that is cut off afterwards.  That keeps the masking on the
device; `index_put_` itself would raise on index n.

Where a scatter can name one destination twice, XLA on the CPU applies the
updates in order, so the last one wins; `index_put_` on CUDA leaves the
winner unspecified.  `_set_drop_last` keeps XLA's rule explicitly: every
row but the last one for its destination is dropped first.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MapCapacity:
    n_kf: int = 256
    n_pt: int = 24576
    n_obs: int = 196608
    n_loop_edges: int = 32   # persistent loop/merge edge slots
    n_desc_hist: int = 8     # per-point descriptor reservoir depth


class MapState(NamedTuple):
    # --- keyframes ---------------------------------------------------------
    kf_R: torch.Tensor        # (K,3,3) R_cw
    kf_t: torch.Tensor        # (K,3)   t_cw
    kf_vel: torch.Tensor      # (K,3)   world-frame velocity (IMU)
    kf_bias: torch.Tensor     # (K,6)   [gyro, acc]
    kf_ts: torch.Tensor       # (K,)    timestamp (s)
    kf_frame_id: torch.Tensor  # (K,)   source frame id
    kf_valid: torch.Tensor    # (K,) bool
    # --- map points --------------------------------------------------------
    pt_xyz: torch.Tensor      # (P,3) world
    pt_desc: torch.Tensor     # (P,8) int32 bit patterns
    pt_normal: torch.Tensor   # (P,3) mean viewing direction
    pt_min_dist: torch.Tensor  # (P,) scale-invariance range
    pt_max_dist: torch.Tensor  # (P,)
    pt_ref_kf: torch.Tensor   # (P,) first-observing KF
    pt_found: torch.Tensor    # (P,) int32 times matched by the tracker
    pt_visible: torch.Tensor  # (P,) int32 times predicted visible
    pt_first_frame: torch.Tensor  # (P,) frame id at creation
    pt_valid: torch.Tensor    # (P,) bool
    # --- observations ------------------------------------------------------
    obs_kf: torch.Tensor      # (O,) int32
    obs_pt: torch.Tensor      # (O,) int32
    obs_uv: torch.Tensor      # (O,2)
    obs_octave: torch.Tensor  # (O,) int32
    obs_ur: torch.Tensor      # (O,) stereo right-u (-1 = mono observation)
    obs_valid: torch.Tensor   # (O,) bool
    # --- persistent loop/merge edges ----------------------------------------
    loop_i: torch.Tensor      # (L,) int32
    loop_j: torch.Tensor      # (L,) int32
    loop_R: torch.Tensor      # (L,3,3)
    loop_t: torch.Tensor      # (L,3)
    loop_s: torch.Tensor      # (L,)
    loop_valid: torch.Tensor  # (L,) bool
    n_loop: torch.Tensor      # () int32
    # --- per-point descriptor reservoir -------------------------------------
    pt_desc_hist: torch.Tensor  # (P, M, 8) int32
    pt_desc_n: torch.Tensor     # (P,) int32 total descriptors pushed
    # --- counters ---------------------------------------------------------
    n_kf: torch.Tensor        # () int32 next free kf slot
    n_pt: torch.Tensor        # () int32 next free point slot
    n_obs: torch.Tensor       # () int32 next free obs slot
    # --- derived incidence: (P, K) bool, point p has (ever had) an
    # observation in KF k; set only through add_observations
    pt_kf_mask: torch.Tensor


def empty_map(cap: MapCapacity, device="cpu") -> MapState:
    K, P, O = cap.n_kf, cap.n_pt, cap.n_obs
    L, M = cap.n_loop_edges, cap.n_desc_hist
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    eye = torch.eye(3, dtype=f32, device=device)
    return MapState(
        kf_R=eye.repeat(K, 1, 1), kf_t=z(K, 3), kf_vel=z(K, 3),
        kf_bias=z(K, 6), kf_ts=z(K), kf_frame_id=full((K,), -1, i32),
        kf_valid=z(K, dtype=torch.bool),
        pt_xyz=z(P, 3), pt_desc=z(P, 8, dtype=i32), pt_normal=z(P, 3),
        pt_min_dist=z(P), pt_max_dist=full((P,), float("inf"), f32),
        pt_ref_kf=full((P,), -1, i32), pt_found=z(P, dtype=i32),
        pt_visible=z(P, dtype=i32), pt_first_frame=full((P,), -1, i32),
        pt_valid=z(P, dtype=torch.bool),
        obs_kf=full((O,), -1, i32), obs_pt=full((O,), -1, i32),
        obs_uv=z(O, 2), obs_octave=z(O, dtype=i32),
        obs_ur=full((O,), -1.0, f32), obs_valid=z(O, dtype=torch.bool),
        loop_i=full((L,), -1, i32), loop_j=full((L,), -1, i32),
        loop_R=eye.repeat(L, 1, 1), loop_t=z(L, 3), loop_s=full((L,), 1.0, f32),
        loop_valid=z(L, dtype=torch.bool), n_loop=z(dtype=i32),
        pt_desc_hist=z(P, M, 8, dtype=i32), pt_desc_n=z(P, dtype=i32),
        n_kf=z(dtype=i32), n_pt=z(dtype=i32), n_obs=z(dtype=i32),
        pt_kf_mask=z(P, K, dtype=torch.bool),
    )


def _on(val, dtype, device) -> torch.Tensor:
    """`val`, a Python scalar or a tensor, as a tensor of `dtype` on
    `device`.  A Python scalar is filled in by a kernel: `torch.as_tensor`
    would copy it from the host, and that copy waits for all queued work."""
    if isinstance(val, torch.Tensor):
        return val.to(dtype=dtype, device=device)
    return torch.full((), val, dtype=dtype, device=device)


def _upload(array, device) -> torch.Tensor:
    """A host array (numpy or nested lists) on `device` without waiting for
    the device's queue: on a card through pinned memory and an asynchronous
    copy (a copy from pageable memory waits for all queued work)."""
    t = torch.as_tensor(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _row(arr: torch.Tensor, i, dim: int = 0) -> torch.Tensor:
    """arr.select(dim, i) for a Python int or a 0-d device index, gathered
    on the device (plain indexing with a 0-d tensor reads the index back
    to the host first).  An index past the end is clamped, as JAX's gather
    clamps it."""
    idx = torch.clamp(_on(i, torch.int64, arr.device), 0, arr.shape[dim] - 1)
    return arr.index_select(dim, idx.reshape(1)).squeeze(dim)


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """arr.at[idx].set(vals, mode="drop") for idx in [0, n]; n drops."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    vals = _on(vals, arr.dtype, arr.device)
    ext.index_put_((idx.long(),), vals.expand((idx.shape[0],) + arr.shape[1:]))
    return ext[:n]


def _last_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) bool: row b is the last row of `idx` (values in [0, n]) that
    names its destination."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx.long(), rows, "amax", include_self=True)
    return last[idx.long()] == rows


def _set_drop_last(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """`_set_drop` where duplicate destinations keep the last row's value."""
    n = arr.shape[0]
    return _set_drop(arr, torch.where(_last_rows(idx, n), idx, n), vals)


def _set_at(arr: torch.Tensor, i: torch.Tensor, val) -> torch.Tensor:
    """arr.at[i].set(val) for a Python int or a 0-d device index; i ==
    len(arr) drops."""
    hit = torch.arange(arr.shape[0], device=arr.device) == i
    val = _on(val, arr.dtype, arr.device)
    return torch.where(hit.reshape((-1,) + (1,) * (arr.dim() - 1)), val, arr)


def add_keyframe(m: MapState, R, t, ts, frame_id, vel=None,
                 bias=None) -> tuple[MapState, torch.Tensor]:
    """Append a keyframe; returns (map, kf_index).  At capacity the write
    is dropped and n_kf saturates at K."""
    K = m.kf_R.shape[0]
    i = m.n_kf
    dev = m.kf_R.device
    m = m._replace(
        kf_R=_set_at(m.kf_R, i, R),
        kf_t=_set_at(m.kf_t, i, t),
        kf_ts=_set_at(m.kf_ts, i, ts),
        kf_frame_id=_set_at(m.kf_frame_id, i, frame_id),
        kf_vel=_set_at(m.kf_vel, i, torch.zeros(3, device=dev) if vel is None else vel),
        kf_bias=_set_at(m.kf_bias, i, torch.zeros(6, device=dev) if bias is None else bias),
        kf_valid=_set_at(m.kf_valid, i, True),
        n_kf=torch.clamp_max(i + 1, K),
    )
    return m, i


def add_points(m: MapState, xyz, desc, normal, min_dist, max_dist,
               ref_kf, frame_id, new_valid) -> tuple[MapState, torch.Tensor]:
    """Append a fixed-size chunk of candidate points (masked by new_valid).
    Valid entries get consecutive slots from n_pt in their original order;
    entries past the capacity are dropped.  Returns (map, point indices
    (B,) int32, -1 for entries not written)."""
    P = m.pt_xyz.shape[0]
    v = new_valid
    vi = v.to(torch.int32)
    base = m.n_pt
    dst = base + torch.cumsum(vi, 0, dtype=torch.int32) - 1
    write = v & (dst < P)
    dst_c = torch.where(write, dst, P)

    def wr(arr, vals):
        return _set_drop(arr, dst_c, vals)

    hist_ext = torch.cat([m.pt_desc_hist, m.pt_desc_hist[:1]])
    hist_ext[dst_c.long(), 0] = desc
    m = m._replace(
        pt_xyz=wr(m.pt_xyz, xyz),
        pt_desc=wr(m.pt_desc, desc),
        pt_normal=wr(m.pt_normal, normal),
        pt_min_dist=wr(m.pt_min_dist, min_dist),
        pt_max_dist=wr(m.pt_max_dist, max_dist),
        pt_ref_kf=wr(m.pt_ref_kf, ref_kf),
        pt_first_frame=wr(m.pt_first_frame, frame_id),
        pt_found=wr(m.pt_found, 1),
        pt_visible=wr(m.pt_visible, 1),
        pt_valid=wr(m.pt_valid, write),
        pt_desc_hist=hist_ext[:P],
        pt_desc_n=wr(m.pt_desc_n, 1),
        n_pt=torch.clamp_max(base + torch.sum(vi), P).to(torch.int32),
    )
    return m, torch.where(write, dst, -1)


def add_observations(m: MapState, kf_idx, pt_idx, uv, octave,
                     valid, ur=None) -> MapState:
    """Append a fixed-size chunk of observations (masked).  `kf_idx` may
    be a scalar or a per-row (B,) tensor.  `ur`: stereo right-u per
    observation (None = mono)."""
    B = pt_idx.shape[0]
    O = m.obs_kf.shape[0]
    P = m.pt_kf_mask.shape[0]
    dev = pt_idx.device
    if ur is None:
        ur = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
    kf_arr = _on(kf_idx, torch.int32, dev).expand(B)
    v = valid & (pt_idx >= 0)
    vi = v.to(torch.int32)
    base = m.n_obs
    dst = base + torch.cumsum(vi, 0, dtype=torch.int32) - 1
    write = v & (dst < O)
    dst_c = torch.where(write, dst, O)

    def wr(arr, vals):
        return _set_drop(arr, dst_c, vals)

    # pt_kf_mask.at[pt, kf].max(write, mode="drop"): set True where written
    mask_ext = torch.cat([m.pt_kf_mask, m.pt_kf_mask[:1]])
    rows = torch.where(write, pt_idx, P).long()
    mask_ext.index_put_((rows, kf_arr.long()), torch.ones_like(write))
    return m._replace(
        obs_kf=wr(m.obs_kf, kf_arr),
        obs_pt=wr(m.obs_pt, pt_idx),
        obs_uv=wr(m.obs_uv, uv),
        obs_octave=wr(m.obs_octave, octave),
        obs_ur=wr(m.obs_ur, ur),
        obs_valid=wr(m.obs_valid, write),
        n_obs=torch.clamp_max(base + torch.sum(vi), O).to(torch.int32),
        pt_kf_mask=mask_ext[:P],
    )


def live_incidence(m: MapState) -> torch.Tensor:
    """(P, K) bool point-KF incidence with dead points/KFs masked out."""
    return m.pt_kf_mask & m.pt_valid[:, None] & m.kf_valid[None, :]


def rebuild_incidence(m: MapState) -> MapState:
    """Recompute pt_kf_mask exactly from the observation list."""
    P, K = m.pt_kf_mask.shape
    ok = m.obs_valid & (m.obs_pt >= 0) & (m.obs_kf >= 0)
    mask = torch.zeros((P + 1, K), dtype=torch.bool, device=ok.device)
    mask.index_put_((torch.where(ok, m.obs_pt, P).long(),
                     torch.clamp(m.obs_kf, 0, K - 1).long()), ok)
    return m._replace(pt_kf_mask=mask[:P])


def point_obs_count(m: MapState) -> torch.Tensor:
    """(P,) number of live observing keyframes per point (replaces
    MapPoint::Observations())."""
    return torch.sum(live_incidence(m).to(torch.int32), dim=1)


def covisibility_weights(m: MapState, kf_idx) -> torch.Tensor:
    """(K,) int32 shared-point counts between `kf_idx` and every other KF
    (reference KeyFrame::UpdateConnections, src/KeyFrame.cc:459)."""
    live = live_incidence(m).to(torch.float32)
    counts = (_row(live, kf_idx, dim=1) @ live).to(torch.int32)
    return _set_at(counts, kf_idx, 0)


# one float32 (P, K) transient is 32 MiB at this entry count; beyond it the
# chunked path keeps the transient at (chunk, K)
_COVIS_DENSE_MAX_ENTRIES = 8 * 1024 * 1024


def covisibility_matrix(m: MapState, chunk: int = 8192,
                        dense_max_entries: int = _COVIS_DENSE_MAX_ENTRIES) -> torch.Tensor:
    """(K, K) float32 shared-point counts W = A^T A over the live incidence
    (the full covisibility graph; reference KeyFrame::UpdateConnections
    pairwise counters, src/KeyFrame.cc:459).  Small maps: one product over
    the float32 incidence.  Beyond the dense cutoff a loop over point blocks
    accumulates W, so that no float32 (P, K) copy exists.  Counts are
    integers below 2^24, exact in float32 in any order."""
    live = live_incidence(m)
    P, K = live.shape
    if P * K <= dense_max_entries:
        A = live.to(torch.float32)
        return A.T @ A
    W = torch.zeros((K, K), dtype=torch.float32, device=live.device)
    for lo in range(0, P, chunk):
        A = live[lo:lo + chunk].to(torch.float32)
        W = W + A.T @ A
    return W


class PointView(NamedTuple):
    """Bounded local-map view for per-frame tracking: the covisibility
    neighbourhood's points gathered into V slots once per keyframe.  `idx`
    maps view slots back to global point slots (-1 = empty)."""
    xyz: torch.Tensor       # (V, 3)
    normal: torch.Tensor    # (V, 3)
    min_dist: torch.Tensor  # (V,)
    max_dist: torch.Tensor  # (V,)
    desc: torch.Tensor      # (V, 8) int32
    valid: torch.Tensor     # (V,) bool
    idx: torch.Tensor       # (V,) int32 global slot, -1 = empty


def gather_local_view(m: MapState, center_kf, n_points: int,
                      window: int = 12) -> PointView:
    """Points of the center KF's covisibility window, most-observed first.

    The window's top-k and the point order use stable sorts: lax.top_k
    and jnp.argsort both keep the lower index first on ties."""
    K = m.kf_R.shape[0]
    dev = m.kf_R.device
    center = center_kf
    covis = covisibility_weights(m, center_kf)
    kf_ids = torch.arange(K, device=dev)
    cscore = torch.where(m.kf_valid & (kf_ids != center), covis, 0)
    top_vals, top_idx = torch.sort(cscore, descending=True, stable=True)
    top_vals, top_idx = top_vals[:max(window - 1, 1)], top_idx[:max(window - 1, 1)]
    kf_mask = torch.zeros(K, dtype=torch.float32, device=dev)
    kf_mask[top_idx] = (top_vals > 0).to(torch.float32)
    kf_mask = _set_at(kf_mask, center, 1.0)
    score = live_incidence(m).to(torch.float32) @ kf_mask
    order = torch.argsort(torch.where(score > 0, -score, float("inf")), stable=True)
    sel = order[:n_points]
    n_in = torch.sum((score > 0).to(torch.int32))
    ok = (torch.arange(n_points, device=dev) < n_in) & m.pt_valid[sel]
    return PointView(
        xyz=m.pt_xyz[sel], normal=m.pt_normal[sel],
        min_dist=m.pt_min_dist[sel], max_dist=m.pt_max_dist[sel],
        desc=m.pt_desc[sel], valid=ok,
        idx=torch.where(ok, sel, -1).to(torch.int32))


def full_view(m: MapState) -> PointView:
    """Identity view over the whole point array (local view disabled)."""
    P = m.pt_xyz.shape[0]
    return PointView(xyz=m.pt_xyz, normal=m.pt_normal,
                     min_dist=m.pt_min_dist, max_dist=m.pt_max_dist,
                     desc=m.pt_desc, valid=m.pt_valid,
                     idx=torch.arange(P, dtype=torch.int32, device=m.pt_xyz.device))


def compact(m: MapState) -> tuple[MapState, torch.Tensor]:
    """Reclaim point/observation slots freed by culling and fusion.

    Stable-partitions valid points and valid observations to the front and
    remaps obs_pt through the point permutation; keyframe slots do not
    move.  Returns (compacted map, point_remap (P,) int32: old index -> new
    index, -1 for dropped points), which the caller applies to its
    bindings."""
    P = m.pt_xyz.shape[0]
    O = m.obs_kf.shape[0]
    dev = m.pt_xyz.device
    i32 = torch.int32
    # ---- points: valid first, in their order
    order = torch.argsort((~m.pt_valid).to(i32), stable=True)
    n_valid = torch.sum(m.pt_valid.to(i32))
    kept = torch.arange(P, device=dev) < n_valid
    remap = torch.empty(P, dtype=i32, device=dev)
    remap[order] = torch.where(kept, torch.arange(P, dtype=i32, device=dev), -1)

    def pg(arr):
        g = arr[order]
        return torch.where(kept.reshape((P,) + (1,) * (arr.dim() - 1)), g,
                           torch.zeros_like(g))

    # ---- observations: drop the ones whose point died, remap the rest
    new_pt = remap[torch.clamp(m.obs_pt, 0, P - 1).long()]
    ov = m.obs_valid & (m.obs_pt >= 0) & (new_pt >= 0)
    oorder = torch.argsort((~ov).to(i32), stable=True)
    n_ov = torch.sum(ov.to(i32))
    okept = torch.arange(O, device=dev) < n_ov

    def og(arr, fill):
        return torch.where(okept.reshape((O,) + (1,) * (arr.dim() - 1)),
                           arr[oorder], fill)

    return m._replace(
        pt_xyz=pg(m.pt_xyz), pt_desc=pg(m.pt_desc), pt_normal=pg(m.pt_normal),
        pt_min_dist=pg(m.pt_min_dist), pt_max_dist=pg(m.pt_max_dist),
        pt_ref_kf=torch.where(kept, m.pt_ref_kf[order], -1),
        pt_found=pg(m.pt_found), pt_visible=pg(m.pt_visible),
        pt_first_frame=torch.where(kept, m.pt_first_frame[order], -1),
        pt_valid=kept & m.pt_valid[order],
        pt_desc_hist=pg(m.pt_desc_hist), pt_desc_n=pg(m.pt_desc_n),
        obs_kf=og(m.obs_kf, -1), obs_pt=og(new_pt, -1),
        obs_uv=og(m.obs_uv, 0.0), obs_octave=og(m.obs_octave, 0),
        obs_ur=og(m.obs_ur, -1.0), obs_valid=okept,
        n_pt=n_valid, n_obs=n_ov,
        pt_kf_mask=pg(m.pt_kf_mask),
    ), remap


def cull_points(m: MapState, current_frame_id, min_found_ratio: float = 0.25,
                min_obs: int = 3, window: int = 90) -> MapState:
    """MapPointCulling parity (reference src/LocalMapping.cc:371-410):
    recent points must keep found/visible >= 0.25 and reach >= min_obs
    observations within a frame-id window of creation; points older than
    3 windows are kept for good."""
    age = current_frame_id - m.pt_first_frame
    ratio = m.pt_found.to(torch.float32) / \
        torch.clamp_min(m.pt_visible.to(torch.float32), 1.0)
    nobs = point_obs_count(m)
    bad = (ratio < min_found_ratio) | ((age > window) & (nobs < min_obs))
    return m._replace(pt_valid=m.pt_valid & ~(bad & (age <= 3 * window)))
