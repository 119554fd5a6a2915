"""Count the blocking host reads of the `System`'s frames on one GPU.

    python -m orbslam3_tpu_torch.utils.sync_census [--frames 40]

Feeds the first `--frames` frames of `seeded_scene`'s default scene to a
`System` on the card with `torch.cuda.set_sync_debug_mode("warn")`, which
warns at every operation that makes the host wait for the device (a
`.cpu()`, `.tolist()`, `int(tensor)`, an index with a 0-d tensor, a library
call that checks its status on the host).  Prints the number of such
operations per frame, grouped by what the frame did (initialization attempt,
the initialising frame, tracked frame, keyframe frame), and where in the
package each comes from.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import subprocess
import traceback
import warnings


def census(cfg, frames: dict, dev) -> dict:
    """{frame kind: (frames of that kind, Counter of `file:line function` ->
    reads)} over cfg.track_frames."""
    import torch
    from ..pipeline import system
    from . import seeded_scene as scene

    sys_ = system.System(scene.system_config(cfg), device=dev)
    kinds: dict = {}
    found = []

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
            for fi in cfg.track_frames:
                was, n_kf = sys_.state, sys_.n_kf_host
                found.clear()
                sys_.track_monocular(frames[fi], fi / 10.0)
                if was != system.OK:
                    kind = "initialising frame" if sys_.state == system.OK else \
                        "initialization attempt"
                else:
                    kind = "keyframe frame" if sys_.n_kf_host > n_kf else "tracked frame"
                n, sites = kinds.setdefault(kind, [0, collections.Counter()])
                kinds[kind][0] = n + 1
                sites.update(found)
    finally:
        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode("default")
    return kinds


def main() -> int:
    import torch
    from . import seeded_scene as scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(scene.SceneConfig(), seed_frames=(),
                              track_frames=tuple(range(args.frames)))
    kinds = census(cfg, scene.render_frames(cfg), torch.device("cuda", 0))
    print(f"card: {card}")
    for kind, (n, sites) in kinds.items():
        print(f"{kind}: {n} frames, {sum(sites.values()) / n:.2f} blocking reads per frame")
        for site, c in sites.most_common():
            print(f"    {c / n:6.2f}  {site}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
