"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths, the per-frame monocular step, the synchronous
keyframe step, the whole `System` from raw frames, its recovery of a lost
track by relocalization and the mono-inertial `System`, at the JAX package's default monocular configuration (480x752 image, 1200 ORB features over 8
levels, map capacity 256 keyframes / 24576 points / 196608 observations, a
local view of 8192 points over 12 keyframes; window BA caps 16 / 4096 /
12288, 6 LM steps over an 8-keyframe window, 4 triangulation neighbours, 768
new points at most):

  1. device: requires CUDA (no CPU fallback) and prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the ORB patch kernels from `orbslam3_tpu_torch/csrc`;
  3. kernels: runs each kernel and its plain PyTorch version on the card at
     the main path's shapes (the port's own 1200 keypoints of a rendered
     frame) and holds them together: K1 moments bit-equal on level-0
     keypoints and within 1e-5 * sum(|w| * I) elsewhere (the summation order
     differs on non-integer pixels); K2 descriptors bit-identical given the
     same angles; the one-launch kernel `orb_describe`: moments bit-equal to
     K1's, angles bit-equal to the plain version's on level-0 keypoints and
     elsewhere within the angle that K1's moment tolerance allows (the
     number of keypoints whose angle bin differs is printed), descriptors
     bit-identical to the plain version's at the kernel's own angles.  Per
     kernel: the CUDA-event time around one launch (median of 50), the
     device duration of the kernel itself from torch.profiler's kernel
     records (median of 50), and the bound: the bytes these keypoints need
     (distinct pixels touched, tables, keypoints, outputs; each once) over
     3.35 TB/s, or the operations over 67 TFLOP/s, whichever is larger.  No
     PyTorch call computes any of the three functions (`library_ms` null);
  4. slice: seeds a map from 4 ground-truth keyframes, builds the local
     view, tracks 24 frames with `frame_step.track_frame` and holds every
     frame to the gates (inliers >= 30, camera centre within 0.05 world
     units and rotation within 0.5 degrees of ground truth).  The launch
     counters are reset before this phase and `orb_describe`'s must equal
     the number of `extract` calls in it (4 + 24), the two single kernels' 0
     (they are launched by phase 3 only);
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
     same point.  `orb_describe`'s counter, reset before this phase's
     seeding, must equal its `extract` calls (4 + 48);
  6. system: builds `System(cfg)` on the card with bench.py's configuration
     (bench.py:103-107: `min_init_matches=60`, `min_track_inliers=20`,
     `max_frames_between_kf=6`) and feeds it bench.py's 78 frames
     (bench.py:110-122) as uint8 images with ts = i / 10 through
     `track_monocular` and nothing else.  The state must be OK no later
     than frame 29 and on every later frame, with no reset and no map
     switch; every tracked frame must have at least `min_track_inliers`
     inliers; keyframes must have been inserted by the system's own decision
     (at least (78 - init frame) // 6 - 1); more than 200 valid map points
     at the end; the trajectory's ATE RMSE against the ground-truth camera
     centres after Umeyama alignment with scale below 0.08 of the path's
     span; map, bank and view on the card; `orb_describe`'s counter equal
     to the frames fed.  The default configuration builds the 65536-word
     keyframe database, and every keyframe of this phase is registered in it;
  7. relocalization: the same `System` then gets 3 textureless frames (fewer
     than `reloc_patience`: RECENTLY_LOST, nothing recovered), then frames
     20-25 of the path rendered again with fresh noise, 1.7 world units
     (about 137 pixels) behind the last pose, beyond what local-map tracking
     from the last pose searches (30 pixels times the octave's scale, 107 at
     most).  The first of them, or the next, must return OK through
     relocalization (its own local-map tracking below `min_track_inliers`),
     with no reset and no stored map, the recovered camera centre within 0.05
     world units (after the trajectory's Umeyama scale) and 0.5 degrees of the
     pose the system gave that frame the first time, and every later frame
     OK with at least `min_track_inliers` inliers; `orb_describe`'s counter
     equal to the 9 frames.  Then `vocab.assign_words` at 65536 words on that
     frame's descriptors against a chunked evaluation with
     `brief.hamming_distance` (identical words), and `keyframe_db.query`
     against a float64 numpy evaluation of the same database (the same masked
     keyframes, scores within 1e-5 relative).  Timed with CUDA events on the
     state from before the kidnap: `add_keyframe`, the query half of an
     attempt (words, BoW vector, scores) and its batch half (8 candidates x
     300 MLPnP hypotheses), and a whole attempt on the host clock;
  8. inertial: builds `InertialSystem(cfg, icfg)` on the card with
     bench.py's mono-inertial configuration (bench.py:210-227: the same
     camera and ORB, `min_init_matches=60`, `min_track_inliers=20`,
     `max_frames_between_kf=6`, the default map capacity; 200 Hz IMU,
     `init_time_s=2.0`, `init_min_kfs=6`, `refine_time_s=5.0`, VIBA2 off)
     and feeds it bench.py's 128 frames (80 + 48) of `utils/imu_scene` as
     bench.py's host loop does: the IMU samples through `grab_imu`, the
     uint8 frame through `track_monocular` (the path's vertical bob ramps in
     after 1.5 s, see `imu_scene`).  OK on every frame after
     initialization, no reset; the IMU initialized by frame 80 and VIBA1
     done by frame 127; more than 200 valid points; the trajectory from the
     IMU initialization on, aligned with scale to the ground truth, with
     |s - 1| < 0.12 and RMSE < 0.1 (metric scale); map, bank, view and bias
     on the card; `orb_describe`'s counter equal to the 128 frames.  Prints
     the IMU-init frame split into `inertial_only_init`, reintegration and
     FullInertialBA, the VI window BA, medians per frame kind on the host
     clock, and launches and device milliseconds of one profiled frame of
     each kind (torch.profiler's kernel records).

Each phase prints one line (phase 6 three more before it, phase 7 four more
after it: kernels per call and device time of `add_keyframe` and of the two
halves of an attempt, from torch.profiler's kernel records; phase 8 one per
frame kind after it); the kernels' JSON
line and the card's line precede the last line, `{"ok": true, "device":
{...}}`.  Any failure raises and exits non-zero before it.
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
    out["launches"] = orb_patches.launch_counts()
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


def relocalization_phase(sys_, scfg, dev, revisit=tuple(range(20, 26))) -> dict:
    """Phase 7 on the `System` that phase 6 drove, which then revisits frames
    `revisit`; raises on a failed check.  Returns the phase's numbers and the
    kernels' launch counts of its drive."""
    import numpy as np
    import torch
    from orbslam3_tpu_torch.features import extractor
    from orbslam3_tpu_torch.ops import brief, orb_patches
    from orbslam3_tpu_torch.pipeline import relocalization
    from orbslam3_tpu_torch.place import keyframe_db as kdb
    from orbslam3_tpu_torch.place import vocab
    from orbslam3_tpu_torch.utils import seeded_scene as scene

    lc = sys_.loop_closer
    if lc is None or lc.cfg.n_words != 65536:
        _fail("the default configuration built no 65536-word keyframe database")
    n_kf = sys_.n_kf_host
    registered = lc.db.active.cpu().numpy()
    if not np.array_equal(registered, sys_.map.kf_valid.cpu().numpy()) or registered.sum() < 5:
        _fail(f"the database holds keyframes {np.nonzero(registered)[0].tolist()} of {n_kf}")
    before = (sys_.map, sys_.bank, lc.db)          # immutable: a snapshot
    n_maps = sys_.atlas.n_maps

    # the drive, counted; the batch's arguments and results are kept
    batches = []
    run_batch = relocalization._reloc_batch

    def spy(*args, **kw):
        out = run_batch(*args, **kw)
        batches.append((args[3], args[4], out[0], out[1]))
        return out

    orb_patches.reset_counters()
    relocalization._reloc_batch = spy
    try:
        d = scene.drive_relocalization(sys_, scfg, revisit, dev)
    finally:
        relocalization._reloc_batch = run_batch
    launches = orb_patches.launch_counts()
    bad = scene.check_reloc_gates(sys_, d, n_maps)
    if len(batches) != 1:
        bad.append(f"{len(batches)} relocalization batches ran")
    if bad:
        _fail("relocalization gates failed: " + "; ".join(bad))
    cand_idx, cand_ok, good, n_inl = (x.cpu().numpy() for x in batches[0])
    winner = int(np.argmax(np.where(good, n_inl, -1)))

    # words at 65536 anchors against a chunked evaluation of the distances
    img = scene.render_revisit(scfg, revisit[:1])[revisit[0]]
    ff = extractor.extract(torch.from_numpy(img).to(dev), scfg.orb)
    words = vocab.assign_words(ff.desc, lc._unpacked)
    best = torch.full((ff.desc.shape[0],), 1 << 20, dtype=torch.int32, device=dev)
    plain = torch.zeros_like(words)
    for lo in range(0, lc.cfg.n_words, 8192):
        dist = brief.hamming_distance(ff.desc, lc.codebook[lo:lo + 8192])
        dmin, arg = torch.min(dist, dim=1)
        closer = dmin < best                        # strictly: the lower word keeps a tie
        plain = torch.where(closer, arg.to(torch.int32) + lo, plain)
        best = torch.where(closer, dmin, best)
    if not torch.equal(words, plain):
        _fail(f"assign_words: {int((words != plain).sum())} words differ from the plain evaluation")

    # the query against float64 numpy on the same database
    db = before[2]
    bow = vocab.bow_vector(words, ff.valid, lc.cfg.n_words)
    scores, common = kdb.query(db, bow)
    tf, has, act = (x.cpu().numpy() for x in db)
    b64 = bow.cpu().numpy().astype(np.float64)
    idf = np.log(max(act.sum(), 1.0) / np.maximum((has & act[:, None]).sum(0), 1.0) + 1.0)
    ref = (tf.astype(np.float64) * idf) @ (b64 * idf)
    common_ref = (has & (b64 > 0)[None, :]).sum(1)
    ok = act & (common_ref >= 5)
    got = scores.cpu().numpy()
    if not np.array_equal(got >= 0, ok) or not np.array_equal(common.cpu().numpy(), common_ref):
        _fail("keyframe_db.query: masked keyframes or common-word counts differ from numpy's")
    score_err = float(np.max(np.abs(got[ok] - ref[ok]) / ref[ok]))
    if not score_err <= 1e-5:
        _fail(f"keyframe_db.query: scores off by {score_err} relative")

    # times (CUDA events), on the state from before the kidnap
    def add_kf():
        lc.db = db
        lc.add_keyframe(before[0], n_kf, ff)

    def query():
        w = vocab.assign_words(ff.desc, lc._unpacked)
        return kdb.query(db, vocab.bow_vector(w, ff.valid, lc.cfg.n_words))

    c_idx, c_ok = batches[0][0], batches[0][1]

    def batch():
        return relocalization._reloc_batch(
            before[0], before[1], ff, c_idx, c_ok, sys_.cam_params, sys_.cfg.cam_model,
            sys_.cfg.orb.scale_factor, sys_.cfg.orb.n_levels, 30, generator=sys_.generator)

    now = (sys_.map, sys_.bank, lc.db)
    prof = {}
    try:
        add_ms = _event_ms(add_kf, runs=20)
        query_ms = _event_ms(query, runs=20)
        batch_ms = _event_ms(batch, runs=5)
        # kernels per call and their summed device time; the word product's
        # own kernel by name
        from orbslam3_tpu_torch.utils import profile_keyframe
        for name, fn, runs in (("add_keyframe", add_kf, 5), ("query", query, 5),
                               ("batch", batch, 3)):
            durs, per_call = profile_keyframe.kernel_durations(fn, ["", "gemm"], runs=runs)
            prof[name] = dict(launches=per_call, device_ms=sum(durs[""]) / runs / 1e3,
                              gemm_ms=sum(durs["gemm"]) / runs / 1e3)
        sys_.map, sys_.bank, lc.db = before
        attempts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hit, _, _ = relocalization.attempt_relocalization(sys_, ff, lc)
            torch.cuda.synchronize()
            attempts.append((time.perf_counter() - t0) * 1e3)
            if not hit:
                _fail("a repeated relocalization attempt on the kidnapped frame failed")
    finally:
        sys_.map, sys_.bank, lc.db = now
    return dict(drive=d, launches=launches, n_admitted=int(cand_ok.sum()),
                candidates=cand_idx[cand_ok].tolist(), n_good=int(good.sum()),
                winner=int(cand_idx[winner]), winner_inliers=int(n_inl[winner]),
                winner_frame=int(before[0].kf_frame_id[int(cand_idx[winner])]),
                score_err=score_err, add_ms=add_ms, query_ms=query_ms, batch_ms=batch_ms,
                attempt_ms=statistics.median(attempts), db_bytes=db.nbytes,
                codebook_bytes=sum(x.numel() * x.element_size() for x in lc._unpacked),
                profile=prof, word_flop=2 * ff.desc.shape[0] * 256 * lc.cfg.n_words,
                n_registered=int(registered.sum()), revisit=revisit, n_blank=scene.N_BLANK)


def inertial_phase(dev) -> dict:
    """Phase 8 on device `dev`: the mono-inertial System on
    `imu_scene.InertialScene()`; raises on a failed gate.  Returns the
    phase's numbers and the kernels' launch counts of its drive."""
    import numpy as np
    import torch
    from orbslam3_tpu_torch.ops import orb_patches
    from orbslam3_tpu_torch.solver import inertial as inertial_solver
    from orbslam3_tpu_torch.utils import imu_scene as scene
    from orbslam3_tpu_torch.utils import profile_keyframe

    cfg = scene.InertialScene()
    t0 = time.perf_counter()
    frames = scene.render_frames(cfg)
    render_s = time.perf_counter() - t0

    def timed(store, fn):
        """fn, with a pair of CUDA events around each call kept in store."""
        def wrapper(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            store.append((start, end))
            return out
        return wrapper

    ev = {"init_solve": [], "fiba": [], "window_ba": [], "imu_stage": []}
    reint = []        # per IMU stage, the reintegrations' events
    solve = inertial_solver.inertial_only_init
    inertial_solver.inertial_only_init = timed(ev["init_solve"], solve)
    profiled, kinds_seen = {}, {}

    def wrap(i, sys_):
        if i == 0:
            # the System's own methods, timed (instance attributes)
            sys_._vi_ba_dispatch = timed(ev["window_ba"], sys_._vi_ba_dispatch)
            sys_._full_ba = timed(ev["fiba"], sys_._full_ba)
            stage = sys_._initialize_imu
            raw = sys_._preint_raw
            in_stage = []

            def stage_spy(*a, **kw):
                in_stage.append(1)
                reint.append([])
                try:
                    return timed(ev["imu_stage"], stage)(*a, **kw)
                finally:
                    in_stage.clear()

            sys_._initialize_imu = stage_spy
            sys_._preint_raw = lambda *a: (timed(reint[-1], raw) if in_stage else raw)(*a)
        kind = scene.expected_kind(sys_, i)
        if kind is None or kind in profiled or i < 10:
            return None
        return profile_keyframe.DeviceWork(kind)

    def on_frame(i, sys_, kind):
        kinds_seen.setdefault(kind, []).append(i)
        w = profile_keyframe.DeviceWork.last
        if w is not None and w.frame is None:
            w.frame = i
            if w.kind == kind:
                profiled[kind] = w
        profile_keyframe.DeviceWork.last = None

    orb_patches.reset_counters()
    t0 = time.perf_counter()
    try:
        sys_, d = scene.drive(cfg, frames, dev, sync=torch.cuda.synchronize, wrap=wrap,
                              on_frame=on_frame)
    finally:
        inertial_solver.inertial_only_init = solve
    phase_s = time.perf_counter() - t0
    launches = orb_patches.launch_counts()
    bad, st = scene.check_gates(cfg, sys_, d)
    if launches != {"ic_moments": 0, "brief_desc": 0, "orb_describe": cfg.frames}:
        bad.append(f"launch counters {launches} for {cfg.frames} frames")
    for name, tensor in (("map", sys_.map.pt_xyz), ("bank", sys_.bank.xy),
                         ("view", sys_.view.xyz), ("bias", sys_.bias)):
        if tensor.device.type != "cuda":
            bad.append(f"the {name} is on {tensor.device}")
    if bad:
        _fail("inertial gates failed: " + "; ".join(bad))
    torch.cuda.synchronize()
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in ev.items()}
    ms["reintegrate"] = [sum(a.elapsed_time(b) for a, b in v) for v in reint]
    ms["reintegrated"] = [len(v) for v in reint]
    prof_frames = {w.frame for w in profiled.values()}
    per_kind = {}
    for kind, idx in kinds_seen.items():
        secs = [d.seconds[i] for i in idx if i not in prof_frames]
        w = profiled.get(kind)
        per_kind[kind] = dict(
            frames=len(idx), median_ms=statistics.median(secs) * 1e3 if secs else None,
            launches=None if w is None else w.launches,
            device_ms=None if w is None else w.device_ms,
            profiled_frame=None if w is None else w.frame)
    return dict(stats=st, drive=d, launches=launches, per_kind=per_kind, ms=ms,
                phase_s=phase_s, render_s=render_s, n_frames=cfg.frames)


def print_inertial(ip: dict) -> None:
    """Phase 8's lines."""
    ist, ims, il = ip["stats"], ip["ms"], ip["launches"]
    print(f"inertial: {ip['n_frames']} frames through grab_imu + track_monocular in "
          f"{ip['phase_s']:.1f} s (rendering {ip['render_s']:.1f} s before); initialised at "
          f"frame {ist['init_frame']}, IMU initialized at frame {ist['imu_init_frame']}, VIBA1 "
          f"at frame {ist['viba1_frame']}; OK on every later frame, 0 resets; {ist['n_kf']} "
          f"keyframes ({ist['n_kf'] - ist['n_kf_valid']} culled), {ist['n_points']} valid map "
          f"points; after the IMU init the trajectory aligns with scale {ist['scale']:.5f} "
          f"(|s - 1| < 0.12), ATE RMSE {ist['ate']:.5g} (< 0.1); map, bank, view and bias on the "
          f"card; launches {il}", flush=True)
    for n, t in enumerate(ims["imu_stage"]):
        # a stage whose scale is refused runs neither the reintegration nor the FIBA
        fiba = f"{ims['fiba'][n]:.1f} ms" if n < len(ims["fiba"]) else "not run"
        print(f"  IMU stage {n + 1}: {t:.1f} ms (CUDA events): inertial_only_init "
              f"{ims['init_solve'][n]:.1f} ms, reintegration of {ims['reintegrated'][n]} factors "
              f"{ims['reintegrate'][n]:.1f} ms, FullInertialBA {fiba}", flush=True)
    wb = ims["window_ba"]
    print(f"  VI window BA: median {statistics.median(wb):.1f} ms over {len(wb)} keyframes "
          f"(CUDA events)" if wb else "  VI window BA: never ran", flush=True)
    for kind, k in ip["per_kind"].items():
        dm = "not measured" if k["device_ms"] is None else f"{k['device_ms']:.2f} ms"
        la = "not measured" if k["launches"] is None else str(k["launches"])
        md = "n/a" if k["median_ms"] is None else f"{k['median_ms']:.1f} ms"
        print(f"  {kind}: {k['frames']} frames, median {md} on the host clock; frame "
              f"{k['profiled_frame']} profiled: {la} kernels, {dm} of device time", flush=True)


def patch_kernel_work(sel, angle) -> dict:
    """Per kernel, the bytes and operations that these keypoints need: the
    distinct pixels the windows touch (each read once), the keypoints, the
    tables and the outputs; 2 multiply-adds per pixel of a moment window, one
    compare per descriptor bit."""
    import numpy as np
    import torch
    from orbslam3_tpu_torch.ops import brief, orient

    atlas, xy = sel.atlas, sel.xy_atlas
    h, w = atlas.shape
    n = xy.shape[0]
    dev = atlas.device

    def distinct(ys, xs):
        hit = torch.zeros(h * w, dtype=torch.bool, device=dev)
        hit[(ys * w + xs).reshape(-1)] = True
        return int(hit.sum())

    r = orient.HALF_PATCH_SIZE
    u = np.arange(-r, r + 1)
    inside = np.abs(u)[None, :] <= orient._umax_table()[np.abs(u)][:, None]
    dy, dx = (torch.from_numpy(a).to(dev) for a in np.nonzero(inside))
    xi = xy.to(torch.int32).long()
    x0 = torch.clamp(xi[:, 0] - r, 0, w - (2 * r + 1))
    y0 = torch.clamp(xi[:, 1] - r, 0, h - (2 * r + 1))
    mom_px = distinct(y0[:, None] + dy[None, :], x0[:, None] + dx[None, :])

    R = brief._PATCH_R
    bins = brief.angle_bins(angle)
    off = brief._offsets_on(str(dev))[bins]
    bx0 = torch.clamp(torch.round(xy[:, 0]).long() - R, 0, w - (2 * R + 1))
    by0 = torch.clamp(torch.round(xy[:, 1]).long() - R, 0, h - (2 * R + 1))
    brf_px = distinct(by0[:, None] + R + off[..., 1], bx0[:, None] + R + off[..., 0])
    table = int(torch.unique(bins).numel()) * 256 * 4      # one char4 per pair

    k1 = dict(bytes=4 * mom_px + 8 * n + 4 * (r + 1) + 8 * n,
              ops=4 * n * int(inside.sum()))
    k2 = dict(bytes=4 * brf_px + 8 * n + 4 * n + table + 32 * n, ops=256 * n)
    fused = dict(bytes=4 * (mom_px + brf_px) + 8 * n + 4 * (r + 1) + table + 4 * n + 32 * n,
                 ops=k1["ops"] + k2["ops"] + 3 * n)
    for k in (k1, k2, fused):
        t_bytes, t_ops = k["bytes"] / 3.35e12 * 1e3, k["ops"] / 67e12 * 1e3
        k.update(bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    return {"ic_moments": k1, "brief_desc": k2, "orb_describe": fused}


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
    from orbslam3_tpu_torch.geometry import twoview
    from orbslam3_tpu_torch.ops import brief, matching, orb_patches, orient
    from orbslam3_tpu_torch.utils import profile_keyframe
    from orbslam3_tpu_torch.utils import seeded_scene as scene

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib, log = orb_patches.build()
    build_s = time.perf_counter() - t0
    if log:
        print(log.strip(), file=sys.stderr)
    print(f"build: {lib.name} in {build_s:.3f} s", flush=True)

    # 3. kernels against their plain versions at the main path's shapes ------
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

    # the one-launch kernel against the composition of the plain versions
    ang_f, desc_f, mom_f = orb_patches.orb_describe(atlas, blur, xy, with_moments=True)
    ang_p, _ = orb_patches.describe_plain(atlas, blur, xy)
    torch.cuda.synchronize()
    if not torch.equal(mom_f, mom_k):
        _fail("orb_describe: moments differ from ic_moments'")
    if not torch.equal(ang_f[lv0], ang_p[lv0]):
        _fail("orb_describe: level-0 angles differ from the plain version's")
    ang_tol = torch.rad2deg(1e-5 * torch.linalg.norm(mass, dim=1)
                            / torch.linalg.norm(mom_t, dim=1)) + 1e-4
    d_ang = (ang_f - ang_p).abs()
    d_ang = torch.minimum(d_ang, 360.0 - d_ang)
    if bool((d_ang > ang_tol).any()):
        _fail(f"orb_describe: angle off by {d_ang.max().item()} deg")
    bins_off = int((brief.angle_bins(ang_f) != brief.angle_bins(ang_p)).sum())
    bins_off_lv0 = int((brief.angle_bins(ang_f) != brief.angle_bins(ang_p))[lv0].sum())
    if bins_off_lv0:
        _fail(f"orb_describe: {bins_off_lv0} level-0 keypoints in another angle bin")
    fused_bits = int(brief.unpack_bits(
        desc_f ^ brief.compute_descriptors(blur, xy, ang_f)).sum(dim=1).max().item())
    if fused_bits != 0:
        _fail(f"orb_describe: descriptors differ from the plain version ({fused_bits} bits)")

    calls = {"ic_moments": lambda: orb_patches.ic_moments(atlas, xy),
             "brief_desc": lambda: orb_patches.brief_descriptors(blur, xy, angle),
             "orb_describe": lambda: orb_patches.orb_describe(atlas, blur, xy)}
    plains = {"ic_moments": lambda: orient.ic_moments(atlas, xy),
              "brief_desc": lambda: brief.compute_descriptors(blur, xy, angle),
              "orb_describe": lambda: orb_patches.describe_plain(atlas, blur, xy)}
    ev_ms = {k: _event_ms(f) for k, f in calls.items()}
    plain_ms = {k: _event_ms(f) for k, f in plains.items()}
    work = patch_kernel_work(sel, ang_f)
    # device durations of the kernels themselves, each through its wrapper,
    # and how many kernels one call of the extractor's last stage launches
    dev_ms = {}
    for k, f in calls.items():
        durs, _ = profile_keyframe.kernel_durations(f, [k + "_kernel"])
        dev_ms[k] = statistics.median(durs[k + "_kernel"]) / 1e3 if durs[k + "_kernel"] else None
    _, per_call = profile_keyframe.kernel_durations(
        lambda: orb_patches.ic_angle_and_descriptors(atlas, blur, xy), [])
    # max_abs_err: moments for K1, descriptor bits for K2, degrees for the
    # one-launch kernel (its descriptor bits stand under `desc_bits_off`)
    err = {"ic_moments": float(k1_err.max().item()), "brief_desc": float(diff_bits),
           "orb_describe": float(d_ang.max().item())}
    bits_off = {"ic_moments": None, "brief_desc": diff_bits, "orb_describe": fused_bits}
    print(f"kernels: {n} keypoints, atlas {tuple(atlas.shape)}; K1 level-0 bit-equal, max|diff| "
          f"{err['ic_moments']:.3g}; K2 bit-identical; orb_describe: moments bit-equal to K1's, "
          f"level-0 angles bit-equal, max angle diff {d_ang.max().item():.3g} deg, "
          f"{bins_off} keypoints in another bin than the plain version's (0 on level 0), "
          f"descriptors bit-identical at its own angles; kernels per call of the last "
          f"extraction stage: {per_call}", flush=True)
    for k in calls:
        d = "not measured" if dev_ms[k] is None else f"{dev_ms[k] * 1e3:.2f} us"
        print(f"  {k}: device {d}, events {ev_ms[k] * 1e3:.2f} us, plain "
              f"{plain_ms[k] * 1e3:.2f} us, bound {work[k]['bound_ms'] * 1e3:.3f} us by "
              f"{work[k]['bound_by']} ({work[k]['bytes']} bytes, {work[k]['ops']} operations)",
              flush=True)

    # 4. the slice ----------------------------------------------------------
    orb_patches.reset_counters()
    t0 = time.perf_counter()
    m0, _, view = scene.seed_map(cfg, frames, dev)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    m, results, secs = scene.track(cfg, m0, view, frames, dev)
    n_extract = len(cfg.seed_frames) + len(cfg.track_frames)
    launches = orb_patches.launch_counts()
    if launches != {"ic_moments": 0, "brief_desc": 0, "orb_describe": n_extract}:
        _fail(f"launch counters {launches} for {n_extract} extract calls")
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
    if kf_launches != {"ic_moments": 0, "brief_desc": 0, "orb_describe": mp["n_extract"]}:
        _fail(f"launch counters {kf_launches} for {mp['n_extract']} extract calls")
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

    # 6. the System from raw frames -------------------------------------------
    scfg = dataclasses.replace(cfg, seed_frames=(), track_frames=tuple(range(78)))
    sframes = scene.render_frames(scfg)
    orb_patches.reset_counters()
    t0 = time.perf_counter()
    sys_, drive = scene.drive_system(scfg, sframes, dev)
    sys_s = time.perf_counter() - t0
    sys_launches = orb_patches.launch_counts()
    bad, st = scene.check_system_gates(sys_, drive)
    if sys_launches != {"ic_moments": 0, "brief_desc": 0,
                        "orb_describe": len(scfg.track_frames)}:
        bad.append(f"launch counters {sys_launches} for {len(scfg.track_frames)} frames")
    for name, tensor in (("map", sys_.map.pt_xyz), ("bank", sys_.bank.xy),
                         ("view", sys_.view.xyz)):
        if tensor.device.type != "cuda":
            bad.append(f"the {name} is on {tensor.device}")
    if bad:
        _fail("system gates failed: " + "; ".join(bad))
    # the two-view reconstruction of the initialising pair, timed on its own
    ff_a = extractor.extract(torch.from_numpy(sframes[st["init"]["ref_frame"]]).to(dev), cfg.orb)
    ff_b = extractor.extract(torch.from_numpy(sframes[st["init"]["frame"]]).to(dev), cfg.orb)
    mm = matching.search_for_initialization(ff_a, ff_b)
    xy_b = ff_b.xy[torch.clamp_min(mm.idx, 0).long()]
    recon_ms = _event_ms(lambda: twoview.reconstruct(
        ff_a.xy, xy_b, mm.valid, sys_.cam_params, generator=sys_.generator), runs=5)
    print(f"system: initialising frame {st['init_ms']:.1f} ms (two-view reconstruction "
          f"alone {recon_ms:.1f} ms: 200 hypotheses of F and H, batched SVD)", flush=True)
    print(f"system: tracked frame median {st['frame_ms']:.3f} ms over {st['n_tracked']} "
          f"frames", flush=True)
    print(f"system: keyframe frame median {st['kf_frame_ms']:.3f} ms over "
          f"{st['n_kf_frames']} frames", flush=True)
    model = "the homography" if st["init"]["used_homography"] else "the fundamental matrix"
    print(f"system: 78 frames through track_monocular in {sys_s:.1f} s; initialised at frame "
          f"{st['init_frame']} against frame {st['init']['ref_frame']} with {model}, "
          f"{st['init']['n_points']} points; OK on every later frame, 0 resets; inliers "
          f"{st['inliers'][0]}-{st['inliers'][1]}; {st['n_kf']} keyframes, {st['n_points']} "
          f"valid map points; ATE RMSE {st['ate']:.5g} after alignment with scale "
          f"{st['scale']:.5g}, {st['ate'] / st['span']:.4f} of the path's span "
          f"{st['span']:.4g}; map, bank and view on the card; launches {sys_launches}",
          flush=True)

    # 7. a lost track recovered by relocalization -----------------------------
    t0 = time.perf_counter()
    rl = relocalization_phase(sys_, scfg, dev)
    reloc_s = time.perf_counter() - t0
    reloc_launches = rl["launches"]
    rd = rl["drive"]
    n_fed = rl["n_blank"] + len(rd.frames)
    if reloc_launches != {"ic_moments": 0, "brief_desc": 0, "orb_describe": n_fed}:
        _fail(f"launch counters {reloc_launches} for {n_fed} frames")
    print(f"relocalization: {rl['n_registered']} keyframes in the database "
          f"({rl['db_bytes']} bytes on the card, unpacked codebook {rl['codebook_bytes']}); "
          f"{rl['n_blank']} textureless frames RECENTLY_LOST, then frame "
          f"{rd.frames[rd.recovered]} of frames {rd.frames[0]}-{rd.frames[-1]} recovered OK by "
          f"relocalization ({rd.inliers[rd.recovered]} inliers from the last pose): "
          f"{rl['n_admitted']} candidates admitted {rl['candidates']}, {rl['n_good']} good, winner "
          f"keyframe {rl['winner']} (frame {rl['winner_frame']}) with {rl['winner_inliers']} "
          f"inliers; centre {rd.centre_err:.4g} world units and {rd.rot_err_deg:.4g} deg from "
          f"the first visit's pose; later frames OK with {min(rd.inliers[rd.recovered + 1:])}-"
          f"{max(rd.inliers[rd.recovered + 1:])} inliers, 0 resets, 0 stored maps; the "
          f"recovering frame {rd.seconds[rd.recovered] * 1e3:.1f} ms; assign_words at 65536 "
          f"words identical to the chunked plain evaluation, query within "
          f"{rl['score_err']:.3g} relative of float64 numpy; add_keyframe "
          f"{rl['add_ms']:.3f} ms, attempt: query {rl['query_ms']:.3f} ms + batch "
          f"{rl['batch_ms']:.3f} ms (CUDA events), whole attempt {rl['attempt_ms']:.3f} ms on "
          f"the host clock; phase {reloc_s:.1f} s; launches {reloc_launches}", flush=True)
    for name, pr in rl["profile"].items():
        print(f"  {name}: {pr['launches']} kernels per call, {pr['device_ms']:.3f} ms of device "
              f"time, {pr['gemm_ms']:.3f} ms of it in matrix-product kernels", flush=True)
    if rl["profile"]:
        gemm = rl["profile"]["add_keyframe"]["gemm_ms"]
        print(f"  word assignment: {rl['word_flop'] / 1e9:.1f} GFLOP in float32, "
              f"{rl['word_flop'] / gemm / 1e9:.1f} TFLOP/s in its product kernel "
              f"(bound {rl['word_flop'] / 67e12 * 1e3:.3f} ms at 67 TFLOP/s)", flush=True)

    # 8. the mono-inertial System -------------------------------------------
    ip = inertial_phase(dev)
    il = ip["launches"]
    print_inertial(ip)

    # report ----------------------------------------------------------------
    src = "orbslam3_tpu_torch/csrc/orb_patches.cu"
    replaces = {"ic_moments": "orbslam3_tpu/ops/pallas_patches.py:58",
                "brief_desc": "orbslam3_tpu/ops/pallas_patches.py:76",
                "orb_describe": "orbslam3_tpu/ops/pallas_patches.py:180"}
    # launches: of the system path's own run.  No path launches the two
    # single kernels: `orb_describe` carries their work in one launch, and
    # phase 3 alone launches them, to hold them against their plain versions
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": sys_launches[k],
         "launches_per_path": {"tracking": launches[k], "keyframe": kf_launches[k],
                               "system": sys_launches[k],
                               "relocalization": reloc_launches[k], "inertial": il[k]},
         "max_abs_err": err[k], "ms": ev_ms[k], "plain_ms": plain_ms[k],
         "bound_ms": work[k]["bound_ms"], "bound_by": work[k]["bound_by"],
         "library_ms": None, "device_ms": dev_ms[k], "bytes": work[k]["bytes"],
         "operations": work[k]["ops"], "desc_bits_off": bits_off[k]}
        for k in ("ic_moments", "brief_desc", "orb_describe")]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
