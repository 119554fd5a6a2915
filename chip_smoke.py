"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, the per-frame monocular step and the
synchronous keyframe step, at the JAX package's default monocular
configuration (480x752 image, 1200 ORB features over 8 levels, map capacity
256 keyframes / 24576 points / 196608 observations, a local view of 8192
points over 12 keyframes; window BA caps 16 / 4096 / 12288, 6 LM steps over
an 8-keyframe window, 4 triangulation neighbours, 768 new points at most):

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
     number of `extract` calls in it (4 + 24);
  5. mapping: seeds the map and the feature bank again and runs bench.py's
     full-system cadence (bench.py:121,166): 48 tracked frames with a
     keyframe step after every 6th (`system.kf_step`, `kf_pose_refresh`,
     `post_ba_stages`: 8 steps, keyframes 4-11, fusion at 4 and 8,
     keyframe culling at 8).  First the first keyframe step runs on the
     CUDA tensors and on a CPU copy of the same inputs, which must agree
     (the same new points from the same keypoints, in the same set of slots,
     and the same bindings, keyframe poses within 1e-4, points within 1e-3
     relative; see `seeded_scene.kf_step_mismatch`).  Then every tracked frame must hold phase 4's
     gates; every keyframe step must make new points whose median |z| is
     within 0.25 of the ground plane and leave every valid keyframe pose
     within the pose gates; after a final `state.compact` the point count
     must equal the valid points and every remapped binding must name the
     same point.  The counters, reset before this phase's seeding, must
     equal its `extract` calls (4 + 48).

Each phase prints one line; the kernels' JSON line and the card's line
precede the last line, `{"ok": true, "device": {...}}`.  Any failure raises
and exits non-zero before it.
"""

from __future__ import annotations

import dataclasses
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


def mapping_phase(cfg, dev) -> dict:
    """Phase 5 on device `dev`; raises on a failed check.  Returns the
    phase's numbers and the kernels' launch counts of its main run."""
    import torch
    from orbslam3_tpu_torch.ops import orb_patches
    from orbslam3_tpu_torch.pipeline import system
    from orbslam3_tpu_torch.slam_map import state as mapstate
    from orbslam3_tpu_torch.utils import seeded_scene as scene

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    frames = scene.render_frames(cfg)
    scfg = scene.slam_config(cfg)
    out = {}

    # the first keyframe step on the device and on a CPU copy
    m, bank, view = scene.seed_map(cfg, frames, dev)
    m, ff, kp_pt, R, t, fi = scene.first_kf_inputs(cfg, m, view, frames, dev)
    ki = len(cfg.seed_frames)

    def step(device):
        mv = lambda x: x.to(device)
        cast = lambda tup: type(tup)(*(mv(x) for x in tup))
        kp_ur = torch.full((ff.xy.shape[0],), -1.0, device=device)
        t0 = time.perf_counter()
        res = system.kf_step(scfg, torch.tensor(cfg.K4, device=device), cast(m),
                             cast(bank), cast(ff), mv(kp_pt), mv(R), mv(t),
                             fi / 10.0, fi, kp_ur, ki)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    ref, cpu_s = step("cpu")
    got, dev_s = step(dev)
    if got[0].kf_R.device.type != dev.type:
        _fail(f"the keyframe step left the device: {got[0].kf_R.device}")
    bad, diff = scene.kf_step_mismatch(ref, got, kp_pt)
    if bad:
        _fail("keyframe step on the device differs from the CPU: " + "; ".join(bad))
    out["first_step"] = dict(n_new=int(got[4]), dev_ms=dev_s * 1e3, cpu_ms=cpu_s * 1e3,
                             diff=diff)

    # the drive, counted
    orb_patches.reset_counters()
    m, bank, view = scene.seed_map(cfg, frames, dev)
    sync()
    pts_before = int(m.pt_valid.sum())
    m, bank, view, results, secs, steps = scene.track_with_keyframes(
        cfg, m, bank, view, frames, dev)
    out["launches"] = {"ic_moments": orb_patches.ic_moments_launches,
                       "brief_desc": orb_patches.brief_desc_launches}
    out["n_extract"] = len(cfg.seed_frames) + len(cfg.track_frames)
    bad = scene.check_gates(cfg, results) + scene.check_kf_gates(cfg, steps)
    if len(steps) != len(cfg.track_frames) // cfg.kf_every:
        bad.append(f"{len(steps)} keyframe steps")
    if bad:
        _fail("mapping gates failed: " + "; ".join(bad))

    # slot compaction and the bindings' remap
    n_valid = int(m.pt_valid.sum())
    mc, remap = mapstate.compact(m)
    kp2 = system.remap_bindings(bank.kp_pt, remap)
    live = (bank.kp_pt >= 0) & (kp2 >= 0)
    if int(mc.n_pt) != n_valid or int(mc.pt_valid.sum()) != n_valid:
        _fail(f"compact: n_pt {int(mc.n_pt)} for {n_valid} valid points")
    if not torch.equal(mc.pt_xyz[kp2[live].long()], m.pt_xyz[bank.kp_pt[live].long()]):
        _fail("compact: a remapped binding names another point")
    if bool(m.pt_valid[bank.kp_pt[(bank.kp_pt >= 0) & (kp2 < 0)].long()].any()):
        _fail("compact: a binding of a valid point was dropped")

    n_kf = int(m.n_kf)
    errs = [scene.pose_errors(R_, t_, fi_) for fi_, R_, t_, _ in results]
    kf_s = [s.seconds for s in steps]
    out.update(
        frame_ms=statistics.median(secs) * 1e3, kf_ms=statistics.median(kf_s) * 1e3,
        amortized_ms=(sum(secs) + sum(kf_s)) / len(secs) * 1e3,
        pts_before=pts_before, pts_after=n_valid, n_kf=n_kf,
        kf_culled=n_kf - int(m.kf_valid[:n_kf].sum()),
        n_new=[s.n_new for s in steps], new_pt_z=[s.new_pt_z for s in steps],
        inliers=(min(r[3] for r in results), max(r[3] for r in results)),
        max_centre_err=max(e[0] for e in errs), max_rot_err=max(e[1] for e in errs),
        max_kf_centre_err=max(scene.pose_errors(R_, t_, f)[0]
                              for s in steps for f, R_, t_ in s.kf_poses))
    return out


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
    m, _, view = scene.seed_map(cfg, frames, dev)
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

    # 5. mapping ------------------------------------------------------------
    kcfg = dataclasses.replace(cfg, track_frames=tuple(range(19, 67)))
    t0 = time.perf_counter()
    mp = mapping_phase(kcfg, dev)
    phase_s = time.perf_counter() - t0
    kf_launches = mp["launches"]
    if any(v != mp["n_extract"] for v in kf_launches.values()):
        _fail(f"launch counters {kf_launches} != {mp['n_extract']} extract calls")
    fs = mp["first_step"]
    print(f"mapping: first keyframe step on the card and on the CPU agree ({fs['n_new']} "
          f"new points, {fs['diff']['relabelled']} of them in swapped slots, max pose |diff| "
          f"{fs['diff']['pose']:.3g}, max point relative diff {fs['diff']['point']:.3g}; "
          f"{fs['dev_ms']:.1f} ms on the card, {fs['cpu_ms']:.1f} ms on the CPU); tracked "
          f"{len(kcfg.track_frames)} frames with {len(mp['n_new'])} keyframe steps in "
          f"{phase_s:.1f} s: median {mp['frame_ms']:.3f} ms per tracked frame, "
          f"median {mp['kf_ms']:.3f} ms per keyframe step, {mp['amortized_ms']:.3f} ms "
          f"per frame amortized; map points {mp['pts_before']} -> {mp['pts_after']}, "
          f"keyframes {mp['n_kf']} ({mp['kf_culled']} culled); new points per step "
          f"{mp['n_new']}, median |z| max {max(mp['new_pt_z']):.4g}; inliers "
          f"{mp['inliers'][0]}-{mp['inliers'][1]}, max centre err "
          f"{mp['max_centre_err']:.4g}, max rot err {mp['max_rot_err']:.4g} deg, max "
          f"keyframe centre err {mp['max_kf_centre_err']:.4g}; launches {kf_launches}",
          flush=True)

    # 6. report -------------------------------------------------------------
    src = "orbslam3_tpu_torch/csrc/orb_patches.cu"
    print(json.dumps({"kernels": [
        {"name": "ic_moments", "route": "cuda", "source": src,
         "replaces": "orbslam3_tpu/ops/pallas_patches.py:58",
         "launches": kf_launches["ic_moments"],
         "launches_per_path": {"tracking": launches["ic_moments"],
                               "keyframe": kf_launches["ic_moments"]},
         "max_abs_err": float(k1_err.max().item()), "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "brief_desc", "route": "cuda", "source": src,
         "replaces": "orbslam3_tpu/ops/pallas_patches.py:76",
         "launches": kf_launches["brief_desc"],
         "launches_per_path": {"tracking": launches["brief_desc"],
                               "keyframe": kf_launches["brief_desc"]},
         "max_abs_err": float(diff_bits), "ms": k2_ms, "plain_ms": k2_plain},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
