"""JAX-side counterparts of the port's seeded-map drive, for the parity tests.

`seed_map_jax` / `track_jax` / `kf_drive_jax` do with the JAX package what
`orbslam3_tpu_torch.utils.seeded_scene.seed_map` / `track` /
`track_with_keyframes` do with the port, on the same numpy frames, so that a
test can hold the two against each other and against ground truth.  The
keyframe step runs through the JAX `System`'s own programs (`_kf_step`,
`_kf_pose_refresh`, `_post_ba_stages`).  Also here: the RANSAC samples that
the JAX MLPnP and relocalization draw from a key, for injection into the
port, and the copy of a JAX `System`'s state and keyframe database into a
port `System`.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import fusion as jfusion
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.pipeline import tracking as jtracking
from orbslam3_tpu.slam_map import feature_bank as jbank
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.features.extractor import OrbParams
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.utils import seeded_scene as ss

torch.set_num_threads(2)

# A small cut of the default configuration: a 240x376 crop of bench.py's
# camera (same focal length, so the same texture scale per pixel), 500
# features over 4 levels, capacities and view cut to fit.
SMALL = ss.SceneConfig(
    hw=(240, 376), K4=(400.0, 400.0, 188.0, 120.0),
    orb=OrbParams(n_features=500, n_levels=4),
    capacity=MapCapacity(n_kf=16, n_pt=4096, n_obs=16384),
    track_frames=tuple(range(19, 27)), view_points=2048)


def jax_params(cfg):
    return jx.OrbParams(n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels)


def jax_capacity(cfg):
    c = cfg.capacity
    return jstate.MapCapacity(n_kf=c.n_kf, n_pt=c.n_pt, n_obs=c.n_obs)


def _pose(i):
    R, t = ss.bench_pose(i)
    return jnp.asarray(R), jnp.asarray(t)


def seed_map_jax(cfg, frames):
    """The JAX twin of seeded_scene.seed_map; returns (map, bank, view)."""
    p = jax_params(cfg)
    cam = jnp.asarray(cfg.K4, jnp.float32)
    m = jstate.empty_map(jax_capacity(cfg))
    bank = None
    for k, fi in enumerate(cfg.seed_frames):
        R, t = _pose(fi)
        ff = jx.extract_jit(jnp.asarray(frames[fi]), p)
        m, ki = jstate.add_keyframe(m, R, t, fi / 10.0, fi)
        if bank is None:
            bank = jbank.empty_bank(cfg.capacity.n_kf, ff.capacity)
        if k == 0:
            Rwc, twc = jlie.se3_inverse(R, t)
            d = jcam.pinhole_unproject(cam, ff.xy) @ Rwc.T
            X = twc + (-twc[2] / d[:, 2])[:, None] * d
            normal, min_d, max_d = jmapping.point_descriptor_stats(
                X, ff.desc, twc, ff.octave, p.scale_factor, p.n_levels)
            m, kp_pt = jstate.add_points(m, X, ff.desc, normal, min_d, max_d,
                                         ki, fi, ff.valid)
            m = jstate.add_observations(m, ki, kp_pt, ff.xy, ff.octave, ff.valid)
        else:
            m, kp_pt, _ = jfusion.fuse_into_keyframe(
                m, ki, ff, jnp.full(ff.xy.shape[0], -1, jnp.int32), "pinhole",
                cam, cfg.hw, p.scale_factor, p.n_levels)
        bank = jbank.set_frame(bank, ki, ff, kp_pt)
    m = m._replace(pt_valid=m.pt_valid & (jstate.point_obs_count(m) >= 2))
    view = jstate.gather_local_view(m, len(cfg.seed_frames) - 1,
                                    cfg.view_points, window=cfg.view_kfs)
    return m, bank, view


@functools.lru_cache(maxsize=None)
def _jax_frame_step(cfg):
    """bench.py's slam_frame (bench.py:138-149) for this configuration."""
    p = jax_params(cfg)
    cam = jnp.asarray(cfg.K4, jnp.float32)

    @jax.jit
    def step(m, view, img, R_prev, t_prev, R_cur, t_cur):
        ff = jx.extract(img, p)
        Rpi, tpi = jlie.se3_inverse(R_prev, t_prev)
        Rv, tv = jlie.se3_compose(R_cur, t_cur, Rpi, tpi)
        Rg, tg = jlie.se3_compose(Rv, tv, R_cur, t_cur)
        tr = jtracking.track_local_map(
            m, ff, Rg, tg, "pinhole", cam, cfg.hw, p.scale_factor, p.n_levels,
            radius_th=jnp.asarray(cfg.radius_th), view=view)
        m2 = jtracking.update_point_stats(m, tr)
        return m2, ff, tr.R, tr.t, tr.kp_pt, tr.n_inliers

    return step


def track_jax(cfg, m, view, frames):
    """The JAX twin of seeded_scene.track: (map, [(frame, R, t, n_inliers)])."""
    step = _jax_frame_step(cfg)
    f0 = cfg.track_frames[0]
    R_prev, t_prev = _pose(f0 - 2)
    R_cur, t_cur = _pose(f0 - 1)
    out = []
    for fi in cfg.track_frames:
        m, _, R, t, _, n_inl = step(m, view, jnp.asarray(frames[fi]),
                                    R_prev, t_prev, R_cur, t_cur)
        out.append((fi, np.asarray(R), np.asarray(t), int(n_inl)))
        R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
    return m, out


def jax_system(cfg):
    """A JAX System with the scene's SlamConfig.  No keyframe database: the
    seeded drives call the keyframe programs directly, outside a `System`, so
    neither side feeds one."""
    return jsystem.System(jsystem.SlamConfig(
        cam_model="pinhole", cam_params=cfg.K4, image_hw=cfg.hw,
        orb=jax_params(cfg), map_capacity=jax_capacity(cfg),
        local_view_points=cfg.view_points, local_view_kfs=cfg.view_kfs,
        max_frames_between_kf=cfg.kf_every, new_pt_budget=cfg.new_pt_budget,
        ba_caps=cfg.ba_caps, enable_relocalization=False))


def kf_step_jax(sys_, m, bank, ff, kp_pt, R, t, fi, ki):
    """One keyframe step (kf_step, pose refresh left to the caller)."""
    kp_ur = jnp.full(ff.xy.shape[0], -1.0, jnp.float32)
    return sys_._kf_step(m, bank, ff, kp_pt, R, t, jnp.asarray(fi / 10.0, jnp.float32),
                         jnp.asarray(fi, jnp.int32), kp_ur, jnp.asarray(ki, jnp.int32))


def post_ba_stages_jax(sys_, m, bank, ki, ff, kp_pt, view, fi):
    """System._post_ba_stages on the given state; returns (map, bank,
    kp_pt of ki, view)."""
    sys_.map, sys_.bank, sys_.last_kf_idx = m, bank, ki
    sys_.kf_bindings[ki] = kp_pt
    sys_._post_ba_stages(ki, ff, fi / 10.0, view=view)
    return sys_.map, sys_.bank, sys_.kf_bindings[ki], sys_.view


def kf_drive_jax(cfg, m, bank, view, frames):
    """The JAX twin of seeded_scene.track_with_keyframes: (map, bank, view,
    [(frame, R, t, n_inliers)], [(ki, frame, n_new, median |z| of the new
    points)])."""
    sys_ = jax_system(cfg)
    step = _jax_frame_step(cfg)
    f0 = cfg.track_frames[0]
    R_prev, t_prev = _pose(f0 - 2)
    R_cur, t_cur = _pose(f0 - 1)
    ki = len(cfg.seed_frames)
    out, steps = [], []
    for n, fi in enumerate(cfg.track_frames, 1):
        m, ff, R, t, kp_pt, n_inl = step(m, view, jnp.asarray(frames[fi]),
                                         R_prev, t_prev, R_cur, t_cur)
        out.append((fi, np.asarray(R), np.asarray(t), int(n_inl)))
        R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
        if n % cfg.kf_every or ki >= cfg.capacity.n_kf - 1:
            continue
        m, bank, _, kp_new, n_new, view = kf_step_jax(sys_, m, bank, ff, kp_pt,
                                                      R, t, fi, ki)
        R_prev, t_prev, R_cur, t_cur = sys_._kf_pose_refresh(
            m, jnp.asarray(ki, jnp.int32), R_cur, t_cur, R_prev, t_prev)
        m, bank, _, view = post_ba_stages_jax(sys_, m, bank, ki, ff, kp_new, view, fi)
        kp_pt, kp_new = np.asarray(kp_pt), np.asarray(kp_new)
        created = kp_new[(kp_pt < 0) & (kp_new >= 0)]
        z = np.abs(np.asarray(m.pt_xyz)[created, 2])
        steps.append((ki, fi, int(n_new), float(np.median(z)) if z.size else np.nan))
        ki += 1
    return m, bank, view, out, steps


def fields(x) -> dict:
    """A JAX NamedTuple as a dict of numpy arrays, for slam_map.convert."""
    return {k: np.asarray(v) for k, v in jax.device_get(x)._asdict().items()}


def copy_system_state(jsys, tsys) -> None:
    """Copy a JAX `System`'s tracker state (map, bank, view, poses, velocity
    flag, keyframe bookkeeping, frame id, state, timestamps) into a port
    `System`, so that both continue from the same point."""
    dev = tsys.device
    tsys.map = convert.map_from_numpy(fields(jsys.map), dev)
    tsys.bank = None if jsys.bank is None else convert.bank_from_numpy(fields(jsys.bank), dev)
    tsys.view = None if jsys.view is None else convert.view_from_numpy(fields(jsys.view), dev)
    for name in ("R_cur", "t_cur", "R_prev", "t_prev"):
        setattr(tsys, name, torch.from_numpy(np.array(getattr(jsys, name), np.float32)).to(dev))
    tsys._pose_host = None
    for name in ("has_velocity", "last_kf_id", "last_kf_idx", "n_kf_host", "last_kf_ts",
                 "inliers_at_last_kf", "frame_id", "state", "lost_frames",
                 "_prev_frame_ts", "localization_only"):
        setattr(tsys, name, getattr(jsys, name))
    tsys.trajectory = [(ts, np.array(R), np.array(t)) for ts, R, t in jsys.trajectory]


def jax_mlpnp_samples(key, valid, inv_sigma2, iterations, sample=6):
    """The (iterations, sample) indices that the JAX `solve_mlpnp` draws with
    `key` (mlpnp.py:169-172), for injection into the port's `idx`."""
    wp = jnp.asarray(valid).astype(jnp.float32) * jnp.asarray(inv_sigma2) + 1e-9
    idx = jax.random.categorical(key, jnp.log(wp)[None, :].repeat(iterations * sample, 0))
    return np.asarray(idx.reshape(iterations, sample))


def jax_reloc_samples(m, bank, ff, cand_idx, cand_ok, key, scale_factor, n_levels):
    """The (C, 300, 6) indices that the JAX `_reloc_batch` draws: one key per
    candidate (relocalization.py:72), each over that candidate's match
    weights, which are recomputed here as `per_cand` computes them."""
    from orbslam3_tpu.ops import matching as jmatching
    P, K = m.pt_xyz.shape[0], bank.desc.shape[0]
    sf = scale_factor ** jnp.clip(ff.octave, 0, n_levels - 1).astype(jnp.float32)
    inv_s2 = 1.0 / (sf * sf)
    keys = jax.random.split(key, len(cand_idx))
    out = []
    for ci, ok, k in zip(np.asarray(cand_idx), np.asarray(cand_ok), keys):
        ci = int(np.clip(ci, 0, K - 1))
        c_kp_pt = bank.kp_pt[ci]
        mm = jmatching.match_nn(
            ff.desc, bank.desc[ci],
            mask=ff.valid[:, None] & bank.valid[ci][None, :] & (c_kp_pt >= 0)[None, :],
            max_dist=jmatching.TH_LOW, nn_ratio=0.75, angles_a=ff.angle,
            angles_b=bank.angle[ci], check_rotation=True)
        pt_idx = jnp.clip(c_kp_pt[jnp.maximum(mm.idx, 0)], 0, P - 1)
        match_ok = mm.valid & m.pt_valid[pt_idx] & bool(ok)
        out.append(jax_mlpnp_samples(k, match_ok, inv_s2, 300))
    return np.stack(out)


def copy_keyframe_db(jsys, tsys) -> None:
    """Copy a JAX `System`'s keyframe database into a port `System`'s."""
    tsys.loop_closer.db = convert.db_from_numpy(fields(jsys.loop_closer.db), tsys.device)
