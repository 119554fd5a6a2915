"""JAX-side counterparts of the port's seeded-map drive, for the parity tests.

`seed_map_jax` / `track_jax` do with the JAX package what
`orbslam3_tpu_torch.utils.seeded_scene.seed_map` / `track` do with the port,
on the same numpy frames, so that a test can hold the two against each other
and against ground truth.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.ops import cameras as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.pipeline import tracking as jtracking
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.features.extractor import OrbParams
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
    """The JAX twin of seeded_scene.seed_map; returns (map, view)."""
    p = jax_params(cfg)
    cam = jnp.asarray(cfg.K4, jnp.float32)
    h, w = cfg.hw
    m = jstate.empty_map(jax_capacity(cfg))
    chunks = []
    for fi in cfg.seed_frames:
        R, t = _pose(fi)
        ff = jx.extract_jit(jnp.asarray(frames[fi]), p)
        Rwc, twc = jlie.se3_inverse(R, t)
        d = jcam.pinhole_unproject(cam, ff.xy) @ Rwc.T
        X = twc + (-twc[2] / d[:, 2])[:, None] * d
        normal, min_d, max_d = jmapping.point_descriptor_stats(
            X, ff.desc, twc, ff.octave, p.scale_factor, p.n_levels)
        m, ki = jstate.add_keyframe(m, R, t, fi / 10.0, fi)
        m, pidx = jstate.add_points(m, X, ff.desc, normal, min_d, max_d,
                                    ki, fi, ff.valid)
        chunks.append((X, pidx, ff.octave))
    for k, fi in enumerate(cfg.seed_frames):
        R, t = _pose(fi)
        for X, pidx, octave in chunks:
            Xc = jlie.se3_apply(R, t, X)
            uv = jcam.pinhole_project(cam, Xc)
            inside = (Xc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
                (uv[:, 1] >= 0) & (uv[:, 1] < h)
            m = jstate.add_observations(m, k, pidx, uv, octave, inside)
    view = jstate.gather_local_view(m, len(cfg.seed_frames) - 1,
                                    cfg.view_points, window=cfg.view_kfs)
    return m, view


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


def fields(x) -> dict:
    """A JAX NamedTuple as a dict of numpy arrays, for slam_map.convert."""
    return {k: np.asarray(v) for k, v in jax.device_get(x)._asdict().items()}
