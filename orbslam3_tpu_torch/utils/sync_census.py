"""Count the blocking host reads of the `System`'s frames on one GPU.

    python -m orbslam3_tpu_torch.utils.sync_census [--frames 40]
    python -m orbslam3_tpu_torch.utils.sync_census --inertial [--frames 128]

Feeds the first `--frames` frames of `seeded_scene`'s default scene to a
`System` on the card, then 2 textureless frames (the track is lost) and
frames 10-12 of the path again (the first is recovered by relocalization), with `torch.cuda.set_sync_debug_mode("warn")`, which
warns at every operation that makes the host wait for the device (a
`.cpu()`, `.tolist()`, `int(tensor)`, an index with a 0-d tensor, a library
call that checks its status on the host).  Prints the number of such
operations per frame, grouped by what the frame did (initialization attempt,
the initialising frame, tracked frame, keyframe frame, lost frame: local-map
tracking failed and the database had no candidate, relocalization attempt: a
batch of candidates was evaluated), and where in the package each comes
from.

The default run then counts one loop closure, kind "loop closure": the
reads of `LoopCloser.try_close` on `loop_scene`'s drifted revisit at the
default capacity (1200-keypoint frames), from detection to the posted GBA.

`--inertial` counts the mono-inertial System's frames instead, on
`imu_scene`'s drive (its first `--frames` frames, 128 by default), grouped
by `imu_scene.frame_kind`: before the IMU initialization the tracked frame
and the keyframe frame as above, then the IMU-init frame (a keyframe frame
that ran an IMU stage), the LastKeyFrame and LastFrame tracked frames and
the inertial keyframe frame (VI window BA).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import subprocess
import traceback
import warnings


N_BLANK = 2
REVISIT = (10, 11, 12)


def census(cfg, frames: dict, dev) -> dict:
    """{frame kind: (frames of that kind, Counter of `file:line function` ->
    reads)} over cfg.track_frames, then `N_BLANK` textureless frames and the
    frames `REVISIT` rendered again."""
    import numpy as np
    import torch
    from ..pipeline import relocalization, system
    from . import seeded_scene as scene

    sys_ = system.System(scene.system_config(cfg), device=dev)
    kinds: dict = {}
    found = []
    batches = []
    run_batch = relocalization._reloc_batch

    def counted_batch(*args, **kw):
        batches.append(1)
        return run_batch(*args, **kw)

    feed = [(frames[fi], fi / 10.0) for fi in cfg.track_frames]
    ts = feed[-1][1]
    again = scene.render_revisit(cfg, REVISIT)
    for img in [np.full(cfg.hw, 128, np.uint8)] * N_BLANK + [again[fi] for fi in REVISIT]:
        ts += 0.1
        feed.append((img, ts))

    relocalization._reloc_batch = counted_batch
    try:
        with _sync_warnings(found):
            for img, ts in feed:
                was, n_kf = sys_.state, sys_.n_kf_host
                found.clear()
                batches.clear()
                sys_.track_monocular(img, ts)
                tracked = was in (system.OK, system.RECENTLY_LOST)
                if batches:
                    kind = "relocalization attempt"
                elif tracked and sys_.last_track_inliers < sys_.cfg.min_track_inliers:
                    kind = "lost frame"
                elif not tracked:
                    kind = "initialising frame" if sys_.state == system.OK else \
                        "initialization attempt"
                else:
                    kind = "keyframe frame" if sys_.n_kf_host > n_kf else "tracked frame"
                n, sites = kinds.setdefault(kind, [0, collections.Counter()])
                kinds[kind][0] = n + 1
                sites.update(found)
    finally:
        relocalization._reloc_batch = run_batch
    return kinds


@contextlib.contextmanager
def _sync_warnings(found: list):
    """Within: every operation that makes the host wait for the device
    appends its call site in the package (`file:line function`) to
    `found`."""
    import torch

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = next((f for f in reversed(traceback.extract_stack()[:-1])
                     if "orbslam3_tpu_torch" in f.filename and "sync_census" not in f.filename),
                    None)
        found.append("?" if site is None else
                     f"{site.filename.split('orbslam3_tpu_torch/')[-1]}:{site.lineno} {site.name}")

    torch.cuda.set_sync_debug_mode("warn")
    showwarning = warnings.showwarning
    warnings.showwarning = note
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            yield
    finally:
        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode("default")


def inertial_census(dev, n_frames: int) -> dict:
    """{frame kind: (frames of that kind, Counter of sites -> reads)} over
    the first n_frames frames of `imu_scene`'s mono-inertial drive."""
    from . import imu_scene as scene

    cfg = scene.InertialScene()
    frames = scene.render_frames(cfg)
    kinds: dict = {}
    found: list = []

    class Frame:
        def __enter__(self):
            found.clear()

        def __exit__(self, *exc):
            return False

    def on_frame(i, sys_, kind):
        n, sites = kinds.setdefault(kind, [0, collections.Counter()])
        kinds[kind][0] = n + 1
        sites.update(found)

    with _sync_warnings(found):
        scene.drive(cfg, frames, dev, n_frames=n_frames, wrap=lambda i, s: Frame(),
                    on_frame=on_frame)
    return kinds


def loop_census(dev) -> dict:
    """{"loop closure": (1, Counter of sites -> reads)} of one
    `try_close` on `loop_scene`'s drifted revisit at the default capacity."""
    from ..pipeline import system
    from . import loop_scene

    sys_ = system.System(system.SlamConfig(cam_params=loop_scene.K4, image_hw=(480, 752),
                                           enable_relocalization=False), device=dev)
    rv = loop_scene.build(sys_, n_kp=1200)
    lc = loop_scene.loop_closer(sys_, rv.kr)
    found: list = []
    with _sync_warnings(found):
        if not lc.try_close(sys_, rv.ff, rv.kr):
            raise RuntimeError("the loop scene did not close")
    return {"loop closure": [1, collections.Counter(found)]}


def main() -> int:
    import torch
    from . import seeded_scene as scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--inertial", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if args.inertial:
        kinds = inertial_census(dev, args.frames or 128)
    else:
        cfg = dataclasses.replace(scene.SceneConfig(), seed_frames=(),
                                  track_frames=tuple(range(args.frames or 40)))
        kinds = census(cfg, scene.render_frames(cfg), dev)
        kinds.update(loop_census(dev))
    print(f"card: {card}")
    for kind, (n, sites) in kinds.items():
        print(f"{kind}: {n} frames, {sum(sites.values()) / n:.2f} blocking reads per frame")
        for site, c in sites.most_common():
            print(f"    {c / n:6.2f}  {site}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
