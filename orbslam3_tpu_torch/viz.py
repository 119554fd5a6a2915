"""Headless map / trajectory visualization.

The port of `orbslam3_tpu/viz.py`.  Parity target: the reference's Pangolin
Viewer/MapDrawer/FrameDrawer (SURVEY L8: an optional GL thread drawing map
points, keyframes, the covisibility graph and the tracked-feature
overlay).  A card in a server is headless, so the equivalent is artifact
export: matplotlib snapshots of the map + trajectory and per-frame
tracked-feature overlays, callable at any time from the host loop.  The
map's tensors are brought to numpy when a plot is made; matplotlib is
imported inside the functions.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def covisibility_edges(system, min_weight: int = 15):
    """(E, 2, 3) segments between keyframe centers sharing >= min_weight
    points (reference MapDrawer::DrawKeyFrames covisibility graph,
    src/MapDrawer.cpp: the green edge set)."""
    from .slam_map import state as mapstate

    m = system.map
    kf_mask = _np(m.kf_valid)
    centers = np.einsum("kji,kj->ki", _np(m.kf_R), -_np(m.kf_t))
    segs = []
    for k in np.nonzero(kf_mask)[0]:
        w = _np(mapstate.covisibility_weights(m, int(k)))
        for j in np.nonzero((w >= min_weight) & kf_mask)[0]:
            if j > k:
                segs.append((centers[k], centers[j]))
    return np.asarray(segs).reshape(-1, 2, 3)


def plot_map(system, path: str, title: str = "orbslam3_tpu map",
             covis_min_weight: int = 15):
    """Top-down + 3D view of map points, keyframes, the covisibility
    graph and trajectory."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = system.map
    pts = _np(m.pt_xyz)[_np(m.pt_valid)]
    kf_mask = _np(m.kf_valid)
    kf_R = _np(m.kf_R)[kf_mask]
    kf_t = _np(m.kf_t)[kf_mask]
    centers = np.einsum("kji,kj->ki", kf_R, -kf_t)
    traj = np.stack([p[2] for p in system.trajectory]) \
        if system.trajectory else np.zeros((0, 3))
    covis = covisibility_edges(system, covis_min_weight) \
        if covis_min_weight > 0 else np.zeros((0, 2, 3))

    fig = plt.figure(figsize=(12, 5))
    ax = fig.add_subplot(1, 2, 1)
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="#888888", label="points")
    for s in covis:
        ax.plot(s[:, 0], s[:, 2], "-", c="#2ca02c", lw=0.6, alpha=0.7)
    if len(covis):
        ax.plot([], [], "-", c="#2ca02c", lw=0.6, label="covisibility")
    if len(traj):
        ax.plot(traj[:, 0], traj[:, 2], "-", c="#d62728", lw=1.5,
                label="trajectory")
    if len(centers):
        ax.scatter(centers[:, 0], centers[:, 2], s=14, c="#1f77b4",
                   marker="s", label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"{title} (top view)")
    ax.axis("equal")
    ax.legend(loc="best", fontsize=8)

    ax3 = fig.add_subplot(1, 2, 2, projection="3d")
    if len(pts):
        ax3.scatter(pts[:, 0], pts[:, 2], pts[:, 1], s=1, c="#888888")
    for s in covis:
        ax3.plot(s[:, 0], s[:, 2], s[:, 1], "-", c="#2ca02c", lw=0.5,
                 alpha=0.7)
    if len(traj):
        ax3.plot(traj[:, 0], traj[:, 2], traj[:, 1], "-", c="#d62728")
    ax3.set_title("3D")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_frame(img, ff, kp_pt, path: str):
    """Tracked-feature overlay (reference FrameDrawer::DrawFrame):
    green = keypoint bound to a map point, blue = unbound keypoint."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    valid = _np(ff.valid)
    xy = _np(ff.xy)
    bound = _np(kp_pt) >= 0
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.imshow(_np(img), cmap="gray", vmin=0, vmax=255)
    ax.scatter(xy[valid & ~bound, 0], xy[valid & ~bound, 1], s=6,
               facecolors="none", edgecolors="#1f77b4", lw=0.8)
    ax.scatter(xy[valid & bound, 0], xy[valid & bound, 1], s=6,
               facecolors="none", edgecolors="#2ca02c", lw=0.8)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


class StepViewer:
    """Step-by-step inspection mode (reference Viewer.cc:160-191:
    menuStepByStep / menuStep pauses the tracker between frames).

    Headless analogue: call `on_frame` from the host loop after each
    tracked frame; it exports the feature overlay (+ a map snapshot
    every `map_every` frames) to numbered files under `out_dir`, and in
    `interactive` mode blocks for Enter between frames so state can be
    inspected (the reference blocks the Tracking thread the same way).
    """

    def __init__(self, out_dir: str, interactive: bool = False,
                 map_every: int = 10):
        import os
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.interactive = interactive
        self.map_every = map_every
        self.n = 0

    def on_frame(self, system, img, ff, kp_pt=None) -> list[str]:
        import os
        outs = []
        if kp_pt is None:
            kp_pt = np.full(_np(ff.xy).shape[0], -1, np.int32)
        if img is not None:
            outs.append(plot_frame(
                img, ff, kp_pt,
                os.path.join(self.out_dir, f"frame_{self.n:05d}.png")))
        if self.n % self.map_every == 0 and system.trajectory:
            outs.append(plot_map(
                system, os.path.join(self.out_dir, f"map_{self.n:05d}.png")))
        self.n += 1
        if self.interactive:
            input(f"[step {self.n}] state={system.state} "
                  f"kf={system.n_kf_host} — Enter to continue ")
        return outs
