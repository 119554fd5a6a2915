"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, the per-frame monocular step, at the JAX
package's default monocular configuration (480x752 image, 1200 ORB
features over 8 levels, map capacity 256 keyframes / 24576 points /
196608 observations, a local view of 8192 points over 12 keyframes):

  1. device: requires CUDA (no CPU fallback) and prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the ORB patch kernels from `orbslam3_tpu_torch/csrc`;
  3. kernels: runs each kernel and its plain PyTorch twin on the card at the
     main path's shapes (the port's own 1200 keypoints of a rendered frame)
     and holds them together: K1 moments bit-equal on level-0 keypoints and
     within 1e-5 * sum(|w| * I) elsewhere (the summation order differs on
     non-integer pixels); K2 descriptors bit-identical given the same
     angles.  Times are CUDA-event medians of 50 runs;
  4. slice: seeds a map from 4 ground-truth keyframes, builds the local
     view, tracks 24 frames with `frame_step.track_frame` and holds every
     frame to the gates (inliers >= 30, camera centre within 0.05 world
     units and rotation within 0.5 degrees of ground truth).  The kernels'
     launch counters are reset before this phase and must each equal the
     number of `extract` calls in it (4 + 24).

Each phase prints one line; the kernels' JSON line and the card's line
precede the last line, `{"ok": true, "device": {...}}`.  Any failure raises
and exits non-zero before it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def _fail(msg: str):
    raise RuntimeError(msg)


def _event_ms(fn, runs: int = 50) -> float:
    """Median CUDA-event milliseconds of `fn` over `runs` launches."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        _fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from orbslam3_tpu_torch.features import extractor
    from orbslam3_tpu_torch.ops import brief, orb_patches, orient
    from orbslam3_tpu_torch.utils import seeded_scene as scene

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib, log = orb_patches.build()
    build_s = time.perf_counter() - t0
    if log:
        print(log.strip(), file=sys.stderr)
    print(f"build: {lib.name} in {build_s:.3f} s", flush=True)

    # 3. kernels against their twins at the main path's shapes --------------
    cfg = scene.SceneConfig()
    frames = scene.render_frames(cfg)
    img = torch.from_numpy(frames[cfg.seed_frames[0]]).to(dev)
    sel = extractor.select_keypoints(img, cfg.orb)
    atlas, blur, xy = sel.atlas, sel.atlas_blur, sel.xy_atlas
    n = xy.shape[0]

    mom_k = orb_patches.ic_moments(atlas, xy)
    mom_t = orient.ic_moments(atlas, xy)
    torch.cuda.synchronize()
    lv0 = sel.octave == 0
    if not torch.equal(mom_k[lv0], mom_t[lv0]):
        _fail("K1 ic_moments: level-0 moments differ from the twin")
    wu, wv = orient._moment_weights()
    absw = torch.from_numpy(np.abs(np.stack([wu, wv], -1))).to(dev)
    mass = torch.einsum("nij,ijc->nc",
                        orient.extract_patches(atlas, xy.to(torch.int32),
                                                orient.HALF_PATCH_SIZE), absw)
    k1_err = (mom_k - mom_t).abs()
    if bool((k1_err > 1e-5 * mass).any()):
        _fail(f"K1 ic_moments: |diff| above 1e-5 * sum|w|I (max {k1_err.max().item()})")

    angle = orient.angle_from_moments(mom_t)
    desc_k = orb_patches.brief_descriptors(blur, xy, angle)
    desc_t = brief.compute_descriptors(blur, xy, angle)
    torch.cuda.synchronize()
    diff_bits = int(brief.unpack_bits(desc_k ^ desc_t).sum(dim=1).max().item())
    if diff_bits != 0:
        _fail(f"K2 brief_desc: descriptors differ from the twin ({diff_bits} bits)")

    k1_ms = _event_ms(lambda: orb_patches.ic_moments(atlas, xy))
    k1_plain = _event_ms(lambda: orient.ic_moments(atlas, xy))
    k2_ms = _event_ms(lambda: orb_patches.brief_descriptors(blur, xy, angle))
    k2_plain = _event_ms(lambda: brief.compute_descriptors(blur, xy, angle))
    print(f"kernels: {n} keypoints, atlas {tuple(atlas.shape)}: K1 ic_moments "
          f"{k1_ms:.4f} ms (twin {k1_plain:.4f} ms), level-0 bit-equal, max|diff| "
          f"{k1_err.max().item():.3g}; K2 brief_desc {k2_ms:.4f} ms (twin "
          f"{k2_plain:.4f} ms), bit-identical", flush=True)

    # 4. the slice ----------------------------------------------------------
    orb_patches.reset_counters()
    t0 = time.perf_counter()
    m, view = scene.seed_map(cfg, frames, dev)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    m, results, secs = scene.track(cfg, m, view, frames, dev)
    n_extract = len(cfg.seed_frames) + len(cfg.track_frames)
    launches = {"ic_moments": orb_patches.ic_moments_launches,
                "brief_desc": orb_patches.brief_desc_launches}
    if any(v != n_extract for v in launches.values()):
        _fail(f"launch counters {launches} != {n_extract} extract calls")
    bad = scene.check_gates(cfg, results)
    if bad:
        _fail("tracking gates failed: " + "; ".join(bad))
    errs = [scene.pose_errors(R, t, fi) for fi, R, t, _ in results]
    inl = [n_ for *_, n_ in results]
    frame_ms = statistics.median(secs) * 1e3
    print(f"slice: seeded {int(m.n_pt)} points / {int(m.n_obs)} observations in "
          f"{seed_s:.2f} s, view {int(view.valid.sum())} points; tracked "
          f"{len(results)} frames, median {frame_ms:.3f} ms/frame (first "
          f"{secs[0] * 1e3:.1f} ms), inliers {min(inl)}-{max(inl)}, max centre "
          f"err {max(e[0] for e in errs):.4g}, max rot err "
          f"{max(e[1] for e in errs):.4g} deg; launches {launches}", flush=True)

    # 5. report -------------------------------------------------------------
    src = "orbslam3_tpu_torch/csrc/orb_patches.cu"
    print(json.dumps({"kernels": [
        {"name": "ic_moments", "route": "cuda", "source": src,
         "replaces": "orbslam3_tpu/ops/pallas_patches.py:58",
         "launches": launches["ic_moments"],
         "max_abs_err": float(k1_err.max().item()), "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "brief_desc", "route": "cuda", "source": src,
         "replaces": "orbslam3_tpu/ops/pallas_patches.py:76",
         "launches": launches["brief_desc"],
         "max_abs_err": float(diff_bits), "ms": k2_ms, "plain_ms": k2_plain},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
