"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths, the per-frame monocular step, the synchronous
keyframe step, the whole `System` from raw frames, its recovery of a lost
track by relocalization, the mono-inertial `System`, loop closing with
the asynchronous keyframe chain, map merging, GNSS georeferencing, the
checkpoint, the stereo, RGB-D, stereo-inertial and KB8 fisheye Systems
(phase 11), the EuRoC / TUM-VI sequence runner (phase 12), the
extraction bench and vocabulary tools (phase 13), the sharded BA within
and across processes (phase 14), bench.py's three chains (phase 15) and the
JAX suite's end-to-end acceptance scenarios (phase 16), at
the JAX package's default monocular configuration (480x752 image, 1200 ORB
features over 8 levels, map capacity 256 keyframes / 24576 points / 196608
observations, a local view of 8192 points over 12 keyframes; window BA caps
16 / 4096 / 12288, 6 LM steps over an 8-keyframe window, 4 triangulation
neighbours, 768 new points at most):

  1. device: requires CUDA (no CPU fallback) and prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the ORB patch kernels from `orbslam3_tpu_torch/csrc`;
  3. kernels: runs each kernel and its plain PyTorch version on the card at
     the main path's shapes (the port's own 1200 keypoints of a rendered
     frame) and holds them together: K1 moments bit-equal on level-0
     keypoints and within 1e-5 * sum(|w| * I) elsewhere (the summation order
     differs on non-integer pixels); K2 descriptors bit-identical given the
     same angles; the one-launch kernels, `orb_describe` (the Hopper design
     that every path runs: a persistent grid, both windows and the bin table
     staged in shared memory by asynchronous copies) and `orb_describe_warp`
     (the earlier design, one warp per keypoint, kept to be timed beside it),
     each: moments bit-equal to K1's, angles bit-equal to the plain
     version's on level-0 keypoints and elsewhere within the angle that K1's
     moment tolerance allows (the number of keypoints whose angle bin
     differs is printed), descriptors bit-identical to the plain version's
     at the kernel's own angles; and the two equal to each other.  Per
     kernel: the CUDA-event time around one launch through its wrapper
     (median of 50), the device duration of the kernel itself from
     torch.profiler's kernel records (median of 50), and the bound: the
     bytes these keypoints need (distinct pixels touched, tables,
     keypoints, outputs; each once) over 3.35 TB/s, or the operations over
     67 TFLOP/s, whichever is larger.  The two one-launch designs are timed
     in turns (warp, Hopper, Hopper, warp: 100 event samples and 100 device
     records each), and an empty kernel's device duration and events time
     are printed as the floor of a launch; then the host clock per call of
     `orb_describe`'s wrapper, its checks, its two output allocations and
     the empty kernel's wrapper (2000 calls each, unsynchronised).  No PyTorch call computes any of
     these functions (`library_ms` null);
  4. slice: seeds a map from 4 ground-truth keyframes, builds the local
     view, tracks 24 frames with `frame_step.track_frame` and holds every
     frame to the gates (inliers >= 30, camera centre within 0.05 world
     units and rotation within 0.5 degrees of ground truth).  The launch
     counters are reset before this phase and `orb_describe`'s must equal
     the number of `extract` calls in it (4 + 24), the two single kernels'
     and `orb_describe_warp`'s 0 (they are launched by phase 3 only);
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
     and feeds it the first `INERTIAL_SMOKE_FRAMES` (72) of bench.py's 128
     frames (80 + 48) of `utils/imu_scene` as bench.py's host loop does:
     the IMU samples through `grab_imu`, the uint8 frame through
     `track_monocular` (the path's vertical bob ramps in after 1.5 s, see
     `imu_scene`).  OK on every frame after initialization, no reset; the
     IMU initialized by frame 80 and VIBA1 done by frame 71 (at 40 and 64
     on the card); more than 200 valid points; the trajectory from the
     IMU initialization on, aligned with scale to the ground truth, with
     |s - 1| < 0.12 and RMSE < 0.1 (metric scale); map, bank, view and bias
     on the card; `orb_describe`'s counter equal to the frames fed.  Prints
     the IMU-init frame split into `inertial_only_init`, reintegration and
     FullInertialBA, the VI window BA, medians per frame kind on the host
     clock, and launches and device milliseconds of one profiled frame of
     each kind (torch.profiler's kernel records);
  9. loop closing: (a) phase 6's System and frames again with
     `async_mapping=True, enable_loop_closing=True`: phase 6's gates,
     `detect` at every inserted keyframe, no loop closed (this path never
     revisits), every keyframe's pending chain merged (at a poll or forced),
     nothing pending after `shutdown()`, map, bank, view and database on the
     card, `orb_describe`'s counter equal to the 78 frames; tracked and
     keyframe frame medians beside phase 6's.  (b) `utils/loop_scene`'s
     drifted revisit at the default capacity with 1200-keypoint frames:
     `LoopCloser.try_close` must close it (one closure, the revisit's centre
     within 0.15 of the origin, its duplicates within 0.2 of the originals,
     loop edge (revisit, 0) persisted), a CPU copy with the same Sim3 samples
     must close the same (winner, matches, inliers; poses within 1e-3), and
     the posted GBA, run on the side stream, is merged by a forced merge
     (centre still within 0.15, every point finite) and held to the same
     GBA run on the CPU from its inputs in what a GBA determines: every
     observation's projection within 0.02 px, points within 1e-4 of the
     map's extent, keyframe 0's and the revisit's poses within 1e-4, the
     same cull verdicts (each exploring keyframe sees only its own points
     and is free to move with them); the CPU copy's own GBA is merged too
     (centre within 0.15).  Then `detect`,
     `solve_sim3`, `optimize_pose_graph` (dense, 256 vertices) and `gba`
     (the capacity-wide PCG, 8 LM steps) are timed alone: CUDA events, and
     kernels and device time per call from torch.profiler's kernel records;
 10. the multi-session Atlas, GNSS georeferencing and the checkpoint
     (`utils/atlas_scene.py`), each part timed on the host clock: (a)
     phase 6's configuration and frames with `enable_loop_closing`, frames
     30-33 a uniform gray image and relocalization switched off on the
     instance (as tests/test_map_merge.py does), so that the occlusion
     resets the map into the Atlas; the second map's keyframes see the
     first's ground and one of them welds it in (`map_merging.try_merge`,
     its Sim3 samples from `loop_scene.fixed_samples`).  Gates: a reset,
     the session consumed, OK from the merge on, at least 2 valid keyframes
     of each session, the merged trajectory over more than 70% of the
     frames with an ATE below 0.08 of the span, the merge edge persisted,
     map, bank and database on the card; the merging keyframe's
     `try_merge` again on a CPU copy of the state it found, with the same
     samples: the same session, candidate, matches, inliers and offsets,
     the Sim3 and the keyframe poses within 1e-3, every integer field of
     the map and the bank and the database's keyframes equal.  Then that
     `try_merge` on the card alone: its stages by CUDA events (the
     database query, `match_nn`, `solve_sim3`, `merge_maps` with the bank
     splice, the welding BA, the database rebuild), kernels and device ms
     of the whole (torch.profiler), its blocking reads.  (b) the same
     frames without the gap, a GNSS fix before each (the true camera
     centre in a geo frame at scale 7, 0.8 rad about z and offset (4.5e6,
     1.1e6, 320), N(0, 0.02) noise from a seeded generator) with
     tests/test_gnss.py's settings: the georeference initialized, GNSS BAs
     posted and every one merged, no reset, every pose finite, the geo
     trajectory within an RMSE of 0.5 of the true geo track; the first
     GNSS BA again on the CPU from its inputs: keyframe centres within
     1e-3 of the map's extent; the GNSS stage by CUDA events, the GNSS BA
     alone by events and its kernels and device ms, blocking reads per
     frame kind (`profile_keyframe.atlas_frame_kind`).  (c) (a)'s merged
     System saved (`slam_map/checkpoint.py`) and loaded into a fresh
     System on the card and one on the CPU: the maps, banks and databases
     equal; 12 more frames of the path on the card with no reset and no
     keyframe slot overwritten; a frame from frame 10's viewpoint
     relocalized by a third System loaded on the card, within 0.05 world
     units of its pose.  `orb_describe`'s counter equal to the 169 frames
     extracted (78 + 78 + 12 + 1).
 11. the other sensors (`utils/sensor_scene.py`), each driven through its
     entry point with the launch counters set to 0 just before its drive
     and read just after: (a) `StereoSystem` with `config.euroc_stereo`'s
     baseline 0.110074 and stereo_bf = fx * b on phase 6's configuration
     and camera, bench.py's 78 frames as rectified pairs (the right camera
     the left one shifted by the baseline along its x axis) through
     `track_stereo`; first the first pair's depths on the card and its
     stereo initialization on the card and on a CPU copy of the same
     keypoints and depths (the same points from the same keypoints, in the
     same slots, positions within 1e-4 relative).  Gates: OK from the first
     pair with at least 100 points, OK on every frame, no reset, every
     tracked frame at `min_track_inliers` or more, the rigid ATE (no scale)
     below 0.025 and the Umeyama scale within 0.025 of 1 (the JAX
     StereoSystem on the same frames on the CPU: 0.0123 and 1.0119;
     tests/test_torch_stereo.py::test_phase_11a_stereo_on_bench_path),
     `orb_describe` 2 x 78.  (b) `RGBDSystem` on the same left frames with
     the plane's depth per pixel through `track_rgbd`: (a)'s gates with the
     ATE below 0.005 and the scale within 0.005 of 1 (JAX: 0.0023, 1.0010),
     `orb_describe` 78.  (c) `StereoInertialSystem` on the raw-KB8 drive of
     tests/test_fisheye_direct_stereo.py:137-234 (its world, motion, 200 Hz
     accelerometer and rig of baseline 0.2; its first
     `FISHEYE_SI_SMOKE_FRAMES` (30) of 70 frames) with the TUM-VI camera
     (TUM-VI cam0's KB8 at 512x512, `tumvi_mono`'s 1000 features): the
     test's gates (no reset, OK at the end, the IMU initialized, rigid RMSE
     < 0.10, |s - 1| < 0.05; the JAX System on the CPU at 70 frames: 0.0111,
     1.0224), `orb_describe` 2 per frame.  (d) `System` with `tumvi_mono`'s KB8
     camera and bench.py's System settings on fisheye views of bench.py's
     78 frames (`render_fisheye_frames`: supersampled, a field stop at 0.9
     rad) through `track_monocular`: phase 6's gates with initialization by
     frame 8 (JAX on the CPU: frame 5) and an ATE below 0.08 of the span
     (JAX: 0.0055), `orb_describe` 78.  Per part: the host-clock median per
     frame kind, one profiled frame per kind (kernels, device ms), the
     blocking reads per frame kind with their sites.
 12. the sequence runner (`orbslam3_tpu_torch/tools/run_euroc.py`): (a) the
     EuRoC-layout tree of tests/test_euroc_tool.py written at full width
     (`utils/euroc_scene.py`: 60 radtan-distorted 480x752 frames of cam0
     and cam1, depth0, a 200 Hz IMU, the ground truth); its cam0 through
     the host decoder and through the native ingest, which must build
     (`csrc/ingest.cpp`; without libpng headers, as on the card's host,
     PIL decodes and feeds its pool; the decoder is printed): the two
     within 0.3 graylevels, 1e-3 where the map's source lies inside the
     image; its first 4 frames through the native ingest with CLAHE (clip
     3.0, grid 8) against the plain stages (`io/ingest_ref.py`): within
     1.5 graylevels away from the CLAHE bins' edges, 0.1 on average.  (b)
     the runner's five arms through `run_euroc.main` on the card (each
     first line must read `ingest: native (...)`), each with the launch
     counters set to 0
     just before it and read just after, under tests/test_euroc_tool.py's
     gates: every frame processed, 0 resets, more than 60% of the frames
     in the TUM file, an ATE below 0.15 of the path's span, |scale - 1|
     below 0.1 for stereo, stereo-inertial and RGB-D; `orb_describe` once
     per mono, mono-inertial or RGB-D frame, twice per stereo pair; the
     map and the bank on the card.  Per arm: frames, fps, keyframes, the
     ATE line, the wait for the images, and per frame kind the host-clock
     median and the blocking reads with their sites (frame 0 left out: its
     reads include the System's construction).  Right after the mono arm,
     the same arm on the host decoder under the same gates (first line
     `ingest: host (...)`): its tracked frames' median beside the native
     ingest's shows whether PIL's decode threads hold the GIL against the
     tracker.  (c) the TUM-VI-layout tree
     (`utils/tumvi_scene.py`: 60 raw KB8 fisheye frames of cam0 and cam1 at
     512x512 and 20 Hz over scenario J's world and path, a 200 Hz IMU in
     the body frame, the ground truth), its cam0 and cam1 through both
     decoders with the TUM-VI preset's rectification maps and 4 frames of
     each with CLAHE (12a's checks and tolerances), then `--dataset tumvi
     --mode stereo-inertial --features 1000 --clahe 3.0` (the native
     ingest's CLAHE on both cameras, the option TUM-VI's users turn on)
     under (b)'s gates (metric), `orb_describe` twice per pair; whether
     the IMU initialized is printed, not gated (with 20 frames between
     keyframes and 2 s of initialization time it need not in 60 frames).
 13. the tools (`orbslam3_tpu_torch/tools/`), each through its `main` on the
     card with the launch counters set to 0 just before it and read just
     after: (a) `drive_extract_bench` at 30 iterations (`orb_describe` 1 +
     30 + 12: the first call, the chain, the profiled steps; a device time
     per `extract` and `orb_describe`'s share of it); (b) `train_vocab`
     cut to 4 views and 256 words: `--stage extract` on the card
     (`orb_describe` 4), then `--stage kmeans` on the card and on the CPU
     from that descriptor file, whose codebooks must be equal; (c)
     `vocab_recall_curve` at 16 places, map sizes 8 and 16, vocabulary 4096
     (`orb_describe` 2 x 16), its rows scored again on the CPU from the
     descriptors the card made: the same recall@1 and recall@3, margins
     within 1e-5.
 14. distribution (`orbslam3_tpu_torch/parallel/`), each part with the
     launch counters set to 0 just before it and read just after (no frame
     is extracted: 0 launches of every kernel): (a) `dist_ba`'s
     `dist_bundle_adjust` on 8 local shards of the card at
     `tools/bench_multihost.py`'s per-shard width (`utils/dist_scene.py`:
     32 cameras, 16,384 points, 65,536 exact observations, 4 LM steps of 32
     PCG steps) in each comm mode: translations within 5e-3 and points within
     5e-3 (mean) of the truth (`tests/test_dist_ba.py`'s gate), the modes
     within 2e-3 of matvec's translations, the same solve on the CPU within
     1e-4 (R, t, X), a second solve bit-equal to the first (the solver's
     sums are deterministic on the card), the collectives per LM iteration
     as counted (matvec 6 + PCG steps, dense 2, camshard 4 + 4 per PCG
     step; printed beside JAX's docstring count), then the same solves
     under an NCCL process group of world size 1 (NCCL's only form on one
     card) bit-equal to those without; per mode the ms per LM iteration by
     CUDA events and the blocking reads per solve.  (b) the monocular System
     on `tests/test_engine_mesh.py`'s scene (`utils/engine_mesh.py`: 42
     synthetic feature frames, caps 16 / 4096 / 12288) with
     `ba_mesh_shards=8` and on one device through the COO PCG solver: JAX's
     gates (both ATEs below 0.05, the two within 0.02, at least 5 keyframes
     and more than 300 points sharded, no reset); the sharded window BAs by
     CUDA events, and on the last map the sharded, grid and one-device COO
     window BAs.  (c) `bench_multihost --procs 2 --dev-per-proc 2` (gloo
     between two processes, the shards on this card) against
     `--local-devices --dev-per-proc 4` at the tool's defaults (`--comm
     dense`): the 2 x 2 solve's translations within 5e-2 and cost within
     20% of the 1 x 4 solve's (`tests/test_multihost.py`'s bounds); then
     `graft_entry.dryrun_multichip` at 1, 2, 4 and 8 shards.
 15. bench.py's chains through `orbslam3_tpu_torch.bench` (its docstring has
     the scenes and where they differ from bench.py), each with the launch
     counters set to 0 just before it and read just after:
     `bench_tracking_chain` (50 random images against a 64 / 8192 / 65536 map:
     the first, the map's own image, tracked to a finite pose with more than
     200 inliers, and every later pose finite where its frame has an inlier:
     `bench.tracking_faults`), `bench_full_system` (30 warm-up frames through
     `System.track_monocular`, then 12 settle and 36 timed chain frames with
     `system.kf_step` every 6th) and `bench_full_inertial` (warmed up until
     the IMU initializes, then 12 settle and, cut for time, 12 timed chain
     frames: `BENCH_INERTIAL_MEASURE`; uncut, 36, in `python -m
     orbslam3_tpu_torch.bench`). Gates:
     the chains' own asserts (the state OK, the IMU initialized, more than 200
     valid points); every timed tracked frame of the full chain with at least
     `min_track_inliers` inliers; both full chains' camera centres within
     phase 6's ATE gate (0.08 of the span, Umeyama with scale) of the scene's
     ground truth and at least one keyframe inserted; the full chain's first
     timed frame and its first keyframe step again on the CPU from copies of
     the same inputs (`bench.recheck_on_cpu`: the pose within 1e-4 and the
     same inliers, then phase 5's `kf_step_mismatch` gates); `orb_describe`
     once per extraction (the chain's, its warm-up's and the census pass's
     over the 12 settle frames that counts the blocking reads per frame kind).
 16. the JAX suite's end-to-end acceptance scenarios
     (`orbslam3_tpu_torch/utils/acceptance.py`, whose docstring has the
     scenes), each through its System's entry points with the launch
     counters set to 0 just before it and read just after, under the JAX
     test's own gates: (A) 36 frames of a lateral sweep at 240x376 with
     `OrbParams(900, 4)` extracted on the card and fed to `System` (no reset,
     at least 24 OK, OK at the end, ATE below 0.08 of the span), (B) the same
     under tests/test_photometric_stress.py's drifting exposure, gamma,
     vignette, blur and noise (at least 22 OK), (C) repeatability >= 0.55,
     TH_HIGH matching recall >= 0.33 and precision >= 0.75 across view and
     light, (D) four places of one texture and a revisit ranked by the
     65,536-word database (the true place first by 1.15x), (E) the same on a
     Voronoi texture family (1.10x), (F) mono-inertial on synthetic features
     with 10x EuRoC IMU noise (no reset, the IMU initialized, over the
     second half of the trajectory |s - 1| < 0.15 and RMSE < 0.12), (G)
     stereo-inertial on synthetic features (no reset, OK, the IMU
     initialized, RMSE without scale < 0.05, |s - 1| < 0.02), (H) the
     270-frame ring lap with loop closing (no reset, OK, ATE < 0.04; the
     loops closed printed), (I) the 60-frame monocular synthetic sequence
     (OK, no reset, > 80% of the frames posed, ATE < 0.05, >= 5 keyframes,
     > 300 points), (J) TUM-VI's configuration from pixels: raw KB8
     fisheye pairs at 384x384 rectified onto a shared pinhole and fed to
     the `StereoInertialSystem` with a 200 Hz accelerometer (no reset, OK,
     the IMU initialized, RMSE without scale < 0.08, |s - 1| < 0.05).  F, G
     and J are cut to their IMU initialization and `ACCEPT_AFTER_IMU`
     frames more.  Per scenario its card check against the CPU: A-E and J
     the first image's extraction on the CPU (the same keypoints, or a
     failure; angle bins, descriptor bits and angles off counted), F-I the
     first tracked frame again on a CPU copy of the state before it (pose
     within 1e-4, the same inliers), J its first two (the first, taken at
     the stereo initialization's pose where the predicted scale levels lie
     within a float rounding of integers, with the card's levels played on
     the copy; the run without them and the levels that differ printed).  `orb_describe` once per image (A, B
     36, C 2, D, E 5, F-I 0, J 2 per frame).  Then `orb_describe` against
     `describe_plain` on B's stressed atlases (frames `STRESSED_FRAMES`)
     and on J's rectified ones (`RECTIFIED_IMAGES`): descriptors
     bit-identical at the kernel's angles, moments bit-equal to
     `ic_moments`'.

Each phase prints one line (phase 3 one per kernel, the floor and the host
line after it; phase 6 three more before it, phase 7 four more
after it: kernels per call and device time of `add_keyframe` and of the two
halves of an attempt, from torch.profiler's kernel records; phase 8 one per
frame kind after it; phase 9 one per part, one per timed stage and its
total; phase 10 one per part, 10a's stages and read sites after it, and its
total; phase 11 a line for the first pair, then per part one line and
one per frame kind, and its total; phase 12 a line for each tree, then per
arm one line and one per frame kind, and its total; phase 13 one line per
tool and its total; phase 14 one per comm mode, one for the engine, three
for the processes and its total; phase 15 one per chain, one for the CPU
recheck and its total; phase 16 one per scenario, one each for the stressed
and the rectified atlases and its total); the kernels' JSON
line and the card's line precede the last line, `{"ok": true, "device":
{...}}`.  Any failure raises and exits non-zero before it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


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


def _to(x, device):
    """A NamedTuple of tensors on `device`."""
    return type(x)(*(y.to(device) for y in x))


def _events(store, fn):
    """fn, with a pair of CUDA events around each call kept in `store` (on
    the CPU, host-clock seconds instead)."""
    import torch

    def wrapper(*a, **kw):
        if not torch.cuda.is_available():
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            store.append(time.perf_counter() - t0)
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        store.append((start, end))
        return out
    return wrapper


def _ms(store) -> list:
    return [x * 1e3 if isinstance(x, float) else x[0].elapsed_time(x[1]) for x in store]


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


# Phases 8 and 11c, cut for the smoke's time limit: the
# mono-inertial drive to 72 of bench.py's 128 frames (its IMU initializes at
# frame 40 and VIBA1 runs at frame 64, on the card as on the CPU, so VIBA1's
# gate is frame 71), the raw-fisheye stereo-inertial drive to 30 of the
# test's 70 frames (its IMU initializes and every gate holds on the CPU: at
# 40 rigid ATE 0.0078, scale 1.0187, at 30 0.0061, 1.0151;
# `tests/acceptance_numbers.py cut 0 30`; cut from 40 for the same 1,218 s
# as phase 15's chain)
INERTIAL_SMOKE_FRAMES = 72
FISHEYE_SI_SMOKE_FRAMES = 30


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

    cfg = scene.InertialScene(frames=INERTIAL_SMOKE_FRAMES, viba1_by=INERTIAL_SMOKE_FRAMES - 1)
    t0 = time.perf_counter()
    frames = scene.render_frames(cfg)
    render_s = time.perf_counter() - t0

    ev = {"init_solve": [], "fiba": [], "window_ba": [], "imu_stage": []}
    reint = []        # per IMU stage, the reintegrations' events
    solve = inertial_solver.inertial_only_init
    inertial_solver.inertial_only_init = _events(ev["init_solve"], solve)
    profiled, kinds_seen = {}, {}

    def wrap(i, sys_):
        if i == 0:
            # the System's own methods, timed (instance attributes)
            sys_._vi_ba_dispatch = _events(ev["window_ba"], sys_._vi_ba_dispatch)
            sys_._full_ba = _events(ev["fiba"], sys_._full_ba)
            stage = sys_._initialize_imu
            raw = sys_._preint_raw
            in_stage = []

            def stage_spy(*a, **kw):
                in_stage.append(1)
                reint.append([])
                try:
                    return _events(ev["imu_stage"], stage)(*a, **kw)
                finally:
                    in_stage.clear()

            sys_._initialize_imu = stage_spy
            sys_._preint_raw = lambda *a: (_events(reint[-1], raw) if in_stage else raw)(*a)
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
    if launches != orb_patches.path_counts(cfg.frames):
        bad.append(f"launch counters {launches} for {cfg.frames} frames")
    for name, tensor in (("map", sys_.map.pt_xyz), ("bank", sys_.bank.xy),
                         ("view", sys_.view.xyz), ("bias", sys_.bias)):
        if tensor.device.type != "cuda":
            bad.append(f"the {name} is on {tensor.device}")
    if bad:
        _fail("inertial gates failed: " + "; ".join(bad))
    torch.cuda.synchronize()
    ms = {k: _ms(v) for k, v in ev.items()}
    ms["reintegrate"] = [sum(_ms(v)) for v in reint]
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


def async_loop_phase(scfg, sframes, dev) -> dict:
    """Phase 9a on device `dev`: phase 6's System with async mapping and
    loop closing on, fed phase 6's frames; raises on a failed gate.  Returns
    the part's numbers."""
    from orbslam3_tpu_torch.pipeline import loop_closing
    from orbslam3_tpu_torch.utils import seeded_scene as scene

    out = {}
    detects = []
    detect = loop_closing.LoopCloser.detect

    def counted_detect(self, m, kf_idx, ff):
        detects.append(kf_idx)
        return detect(self, m, kf_idx, ff)

    loop_closing.LoopCloser.detect = counted_detect
    t0 = time.perf_counter()
    try:
        sys_, d = scene.drive_system(scfg, sframes, dev, async_mapping=True,
                                     enable_loop_closing=True)
        counts_at_end = dict(sys_.chain_counts)
        pending_at_end = sys_._pending is not None
        sys_.shutdown()
    finally:
        loop_closing.LoopCloser.detect = detect
    out["a_s"] = time.perf_counter() - t0
    bad, st = scene.check_system_gates(sys_, d)
    c = sys_.chain_counts
    n_ins = sys_.n_kf_host - 2
    if sorted(detects) != list(range(2, sys_.n_kf_host)):
        bad.append(f"detect ran at keyframes {detects}, {n_ins} were inserted")
    if sys_.loop_closer.n_loops_closed:
        bad.append(f"{sys_.loop_closer.n_loops_closed} false loop closures")
    if c["posted kf"] != n_ins or c["merged kf at a poll"] + c["merged kf forced"] != n_ins:
        bad.append(f"chains {dict(c)} for {n_ins} keyframes")
    if sys_._pending is not None:
        bad.append("a chain pending after shutdown")
    for name, tensor in (("map", sys_.map.pt_xyz), ("bank", sys_.bank.xy),
                         ("view", sys_.view.xyz), ("database", sys_.loop_closer.db.tf)):
        if tensor.device.type != "cuda":
            bad.append(f"the {name} is on {tensor.device}")
    if bad:
        _fail("async mapping with loop closing: " + "; ".join(bad))
    out.update(a_stats=st, chains=dict(c), chains_before_shutdown=counts_at_end,
               pending_at_end=pending_at_end, n_detect=len(detects))
    return out


def closure_phase(dev) -> dict:
    """Phase 9b: a closure at the default capacity on `loop_scene`'s
    drifted revisit, on the card and on a CPU copy with the same Sim3
    samples, then its parts timed alone; raises on a failed gate.  Returns
    the part's numbers."""
    import numpy as np
    import torch
    from orbslam3_tpu_torch.geometry import sim3solver
    from orbslam3_tpu_torch.pipeline import system
    from orbslam3_tpu_torch.solver import pose_graph
    from orbslam3_tpu_torch.utils import loop_scene, profile_keyframe

    out = {}
    seen = {}
    solve, optimize = sim3solver.solve_sim3, pose_graph.optimize_pose_graph

    def spy(name, fn):
        def wrapper(*a, **kw):
            seen.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapper

    def closure(device):
        cfg = system.SlamConfig(cam_params=loop_scene.K4, image_hw=(480, 752),
                                enable_relocalization=False)
        s_ = system.System(cfg, device=device)
        rv = loop_scene.build(s_, n_kp=1200)
        lc = loop_scene.loop_closer(s_, rv.kr)
        before = (s_.map, s_.bank)
        sync = torch.cuda.synchronize if s_.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        if not lc.try_close(s_, rv.ff, rv.kr, idx_fn=loop_scene.fixed_samples):
            _fail(f"the loop scene did not close on {device}")
        sync()
        return s_, rv, lc, before, (time.perf_counter() - t0) * 1e3

    sim3solver.solve_sim3 = spy("sim3", solve)
    pose_graph.optimize_pose_graph = spy("pose_graph", optimize)
    try:
        g, rv, lc, before, close_ms = closure(dev)
    finally:
        sim3solver.solve_sim3, pose_graph.optimize_pose_graph = solve, optimize
    c, _, lc_c, _, cpu_ms = closure("cpu")
    m, kr = g.map, rv.kr
    centre = float(torch.linalg.norm(-m.kf_R[kr].T @ m.kf_t[kr]))
    dup = float(np.linalg.norm(m.pt_xyz[rv.pt_dup.long()].cpu().numpy() - rv.X0[:rv.pt_dup.shape[0]],
                               axis=1).mean())
    bad = []
    if lc.n_loops_closed != 1 or centre >= 0.15 or dup >= 0.2:
        bad.append(f"{lc.n_loops_closed} closures, centre {centre}, duplicates {dup}")
    if int(m.n_loop) != 1 or (int(m.loop_i[0]), int(m.loop_j[0])) != (kr, 0):
        bad.append(f"loop edges {int(m.n_loop)}: {m.loop_i[:1].tolist()}, {m.loop_j[:1].tolist()}")
    if lc.last_closure != lc_c.last_closure:
        bad.append(f"the card closed {lc.last_closure}, the CPU {lc_c.last_closure}")
    nk = g.n_kf_host
    pose_diff = max(float((m.kf_R[:nk].cpu() - c.map.kf_R[:nk]).abs().max()),
                    float((m.kf_t[:nk].cpu() - c.map.kf_t[:nk]).abs().max()))
    if not pose_diff < 1e-3:
        bad.append(f"keyframe poses {pose_diff} from the CPU's")
    pend = g._pending
    if pend is None or pend.kind != "gba" or (g.device.type == "cuda" and pend.done is None):
        bad.append("no GBA posted on the side stream" if pend is None else
                   f"a {pend.kind} chain posted, its event {pend.done}")
    else:
        # the GBA's inputs as the side stream read them, copied to the CPU
        # after the current stream's work (the copy waits for nothing else)
        m_in, bank_in = (type(x)(*(y.cpu() for y in x)) for x in pend.inputs)
        g._merge_pending(force=True)
        torch.cuda.synchronize()
        m = g.map
        centre_gba = float(torch.linalg.norm(-m.kf_R[kr].T @ m.kf_t[kr]))
        if g._pending is not None or centre_gba >= 0.15 or not bool(torch.isfinite(m.pt_xyz).all()):
            bad.append(f"after the GBA: centre {centre_gba}, pending "
                       f"{g._pending is not None}")
        # the same GBA on the CPU from those inputs.  The exploring keyframes
        # each see only their own points, so a GBA leaves each such keyframe
        # free to move with its points (a similarity gauge) and float
        # rounding moves them apart by up to ~0.03; what the GBA determines
        # is held: every observation's projection within 0.02 px, points
        # within 1e-4 of the map's extent, keyframe 0 and the revisit
        # keyframe (they share the fused points) within 1e-4, the same cull
        # verdicts
        ref = system.gba(c.cfg, c.cam_params, m_in, kr, bank_in)
        m_c = type(m)(*(x.cpu() for x in m))
        ok = ref.pt_valid
        uv_g, meas = loop_scene.reprojections(m_c)
        uv_r, meas_r = loop_scene.reprojections(ref)
        gba_uv = float((uv_g - uv_r).abs().max()) if torch.equal(meas, meas_r) else float("inf")
        gba_pose = max(float((getattr(m_c, f)[k] - getattr(ref, f)[k]).abs().max())
                       for f in ("kf_R", "kf_t") for k in (0, kr))
        gba_free = float((m_c.kf_t[:nk] - ref.kf_t[:nk]).abs().max())
        gba_pts = float((m_c.pt_xyz[ok] - ref.pt_xyz[ok]).abs().max() / ref.pt_xyz[ok].abs().max())
        gba_rms = float(((uv_g - meas) ** 2).sum(1).mean().sqrt())
        if not (gba_uv < 0.02 and gba_pose < 1e-4 and gba_pts < 1e-4) or \
                not torch.equal(m_c.pt_valid, ok):
            bad.append(f"the card's GBA from the CPU's on the same inputs: projections {gba_uv} "
                       f"px, poses of keyframes 0 and {kr} {gba_pose}, points {gba_pts} of the "
                       f"extent")
        # the CPU copy's own GBA (run inline in its try_close), merged: its
        # input differs from the card's by the closure's rounding, and the
        # exploring keyframes, each alone with its points, are free in the
        # GBA's gauge, so only its gates are held
        c._merge_pending(force=True)
        cm = c.map
        centre_cpu = float(torch.linalg.norm(-cm.kf_R[kr].T @ cm.kf_t[kr]))
        if c._pending is not None or centre_cpu >= 0.15:
            bad.append(f"the CPU copy's GBA: centre {centre_cpu}, pending {c._pending is not None}")
        gba_copy = max(float((m.kf_R[:nk].cpu() - cm.kf_R[:nk]).abs().max()),
                       float((m.kf_t[:nk].cpu() - cm.kf_t[:nk]).abs().max()))
        out.update(centre_gba=centre_gba, gba_pose=gba_pose, gba_pts=gba_pts, gba_uv=gba_uv,
                   gba_free=gba_free, gba_rms=gba_rms, centre_cpu=centre_cpu,
                   gba_copy=gba_copy)
    if bad:
        _fail("loop closure at the default capacity: " + "; ".join(bad))
    out.update(closure=lc.last_closure, centre=centre, dup=dup, pose_diff=pose_diff,
               close_ms=close_ms, cpu_ms=cpu_ms)

    # the parts alone: CUDA events, then kernels and device time per call
    m0, bank0 = before
    sa, skw = seen["sim3"]
    pa, pkw = seen["pose_graph"]
    parts = {
        "detect": (lambda: lc.detect(m0, kr, rv.ff), 5),
        "solve_sim3": (lambda: solve(*sa, **skw), 5),
        "optimize_pose_graph": (lambda: optimize(*pa, **pkw), 2),
        "gba": (lambda: system.gba(g.cfg, g.cam_params, m0, kr, bank0), 2)}
    timed = {}
    for name, (fn, runs) in parts.items():
        ms = _event_ms(fn, runs=runs)
        durs, per_call = profile_keyframe.kernel_durations(fn, [""], runs=1)
        timed[name] = dict(ms=ms, launches=per_call, device_ms=sum(durs[""]) / 1e3)
    out["parts"] = timed
    out["capacity"] = g.cfg.map_capacity
    return out


def print_loop(lp: dict, st6: dict) -> None:
    """Phase 9's lines."""
    a, ch = lp["a_stats"], lp["chains"]
    print(f"loop 9a: phase 6's 78 frames with async mapping and loop closing in "
          f"{lp['a_s']:.1f} s: initialised at frame {a['init_frame']}, OK on every later "
          f"frame, 0 resets, {a['n_kf']} keyframes, {a['n_points']} points, ATE "
          f"{a['ate']:.5g} ({a['ate'] / a['span']:.4f} of the span); detect at every "
          f"keyframe ({lp['n_detect']}), 0 loops closed; keyframe chains posted "
          f"{ch.get('posted kf', 0)}, merged at a poll {ch.get('merged kf at a poll', 0)}, "
          f"forced {ch.get('merged kf forced', 0)} (at the last frame: "
          f"{lp['chains_before_shutdown']}, pending {lp['pending_at_end']}), none pending "
          f"after shutdown; medians on the host clock: tracked frame {a['frame_ms']:.3f} ms, "
          f"keyframe frame {a['kf_frame_ms']:.3f} ms (phase 6, synchronous, this run: "
          f"{st6['frame_ms']:.3f} / {st6['kf_frame_ms']:.3f} ms)", flush=True)
    cap, cl = lp["capacity"], lp["closure"]
    print(f"loop 9b: drifted revisit at {cap.n_kf} / {cap.n_pt} / {cap.n_obs} with "
          f"1200-keypoint frames: keyframe {cl['kf']} closed with keyframe {cl['cand']} "
          f"({cl['n_matches']} matches, {cl['n_inliers']} Sim3 inliers), centre "
          f"{lp['centre']:.4g} from the origin (< 0.15), duplicates {lp['dup']:.4g} from the "
          f"originals (< 0.2), loop edge persisted; the CPU copy with the same samples closed "
          f"the same, poses within {lp['pose_diff']:.3g}; the GBA posted on the side stream, "
          f"merged forced, centre {lp['centre_gba']:.4g} after it, every point finite, "
          f"against the same GBA on the CPU from its inputs: projections within "
          f"{lp['gba_uv']:.3g} px (RMS residual {lp['gba_rms']:.3g} px), points within "
          f"{lp['gba_pts']:.3g} of the extent, keyframes 0 and {cl['kf']} within "
          f"{lp['gba_pose']:.3g}, the gauge-free exploring keyframes' translations "
          f"{lp['gba_free']:.3g} apart; the CPU copy's own GBA merged: centre "
          f"{lp['centre_cpu']:.4g}, translations {lp['gba_copy']:.3g} from the card's; "
          f"try_close {lp['close_ms']:.1f} ms on the host clock (CPU copy, its GBA "
          f"inline, {lp['cpu_ms']:.1f} ms)", flush=True)
    for name, t in lp["parts"].items():
        print(f"  {name}: {t['ms']:.3f} ms (CUDA events), {t['launches']} kernels, "
              f"{t['device_ms']:.3f} ms of device time", flush=True)


def _merge_system(snap: dict, device):
    """A System on `device` in the state the merging keyframe's `try_merge`
    found (`snap`, recorded by `merge_phase`)."""
    from orbslam3_tpu_torch.pipeline import system
    from orbslam3_tpu_torch.slam_map import atlas
    s = system.System(snap["cfg"], device=device)
    s.map, s.bank = _to(snap["map"], device), _to(snap["bank"], device)
    s.n_kf_host, s.last_kf_idx = snap["n_kf"], snap["ki"]
    s.trajectory = list(snap["trajectory"])
    s.atlas.sessions = [atlas.MapSession(_to(x.map, device), _to(x.bank, device),
                                         list(x.trajectory), _to(x.db, device))
                        for x in snap["sessions"]]
    s.loop_closer.db = _to(snap["db"], device)
    s._set_pose(snap["R"].to(device), snap["t"].to(device))
    s.R_prev, s.t_prev = s.R_cur, s.t_cur
    return s, _to(snap["ff"], device)


def merge_phase(scfg, frames, dev) -> dict:
    """Phase 10a: bench.py's 78 frames with frames 30-33 blank and
    `enable_loop_closing` (`atlas_scene.drive_merge`), the merge's Sim3
    samples from `loop_scene.fixed_samples`; then the merging keyframe's
    `try_merge` again from the state it found, on a CPU copy (the same
    outcome) and on the card (stages by CUDA events, kernels and device ms
    under the profiler, blocking reads).  Raises on a failed gate."""
    import numpy as np
    import torch
    from orbslam3_tpu_torch.geometry import sim3solver
    from orbslam3_tpu_torch.ops import matching
    from orbslam3_tpu_torch.pipeline import map_merging
    from orbslam3_tpu_torch.place import keyframe_db as kdb
    from orbslam3_tpu_torch.slam_map import atlas
    from orbslam3_tpu_torch.slam_map import feature_bank as fb
    from orbslam3_tpu_torch.utils import atlas_scene, loop_scene, profile_keyframe, sync_census

    run = map_merging.try_merge
    seen = {}

    def spy(sys_, ff, ki, **kw):
        snap = dict(cfg=sys_.cfg, map=sys_.map, bank=sys_.bank, n_kf=sys_.n_kf_host, ki=ki,
                    trajectory=list(sys_.trajectory), db=sys_.loop_closer.db, ff=ff,
                    sessions=[atlas.MapSession(x.map, x.bank, list(x.trajectory), x.db)
                              for x in sys_.atlas.sessions], R=sys_.R_cur, t=sys_.t_cur)
        t0 = time.perf_counter()
        out = run(sys_, ff, ki, idx_fn=loop_scene.fixed_samples)
        if out:
            seen.update(snap=snap, host_ms=(time.perf_counter() - t0) * 1e3,
                        after=(sys_.map, sys_.bank, sys_.loop_closer.db, dict(sys_.last_merge)))
        seen["attempts"] = seen.get("attempts", 0) + 1
        return out

    map_merging.try_merge = spy
    t0 = time.perf_counter()
    try:
        sys_, d = atlas_scene.drive_merge(scfg, frames, dev)
    finally:
        map_merging.try_merge = run
    drive_s = time.perf_counter() - t0
    bad, st = atlas_scene.check_merge_gates(sys_, d)
    if not bad:
        bad = [f"the {name} is on {x.device}" for name, x in (
            ("map", sys_.map.pt_xyz), ("bank", sys_.bank.xy),
            ("database", sys_.loop_closer.db.tf)) if x.device.type != dev.type]
    if bad:
        _fail("merge gates failed: " + "; ".join(bad))

    # the merging keyframe's try_merge on a CPU copy of the state it found
    snap = seen["snap"]
    m_g, bank_g, db_g, lm_g = seen["after"]
    c, ff_c = _merge_system(snap, "cpu")
    t0 = time.perf_counter()
    if not run(c, ff_c, snap["ki"], idx_fn=loop_scene.fixed_samples):
        _fail("the CPU copy of the merging keyframe did not merge")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    keys = ("session", "kf", "cand", "n_matches", "n_inliers", "kf_off", "pt_off")
    if [c.last_merge[k] for k in keys] != [lm_g[k] for k in keys]:
        bad.append(f"the card merged {[lm_g[k] for k in keys]}, the CPU "
                   f"{[c.last_merge[k] for k in keys]}")
    sim3_diff = max(float(np.abs(np.asarray(lm_g[k]) - np.asarray(c.last_merge[k])).max())
                    for k in ("R", "t", "s"))
    nk = c.n_kf_host
    pose_diff = max(float((getattr(m_g, f)[:nk].cpu() - getattr(c.map, f)[:nk]).abs().max())
                    for f in ("kf_R", "kf_t"))
    ints = [f for f, x in c.map._asdict().items() if not x.is_floating_point()
            and not torch.equal(getattr(m_g, f).cpu(), x)]
    ints += [f"bank.{f}" for f, x in c.bank._asdict().items() if not x.is_floating_point()
             and not torch.equal(getattr(bank_g, f).cpu(), x)]
    if not torch.equal(db_g.active.cpu(), c.loop_closer.db.active):
        ints.append("database.active")
    if not (sim3_diff < 1e-3 and pose_diff < 1e-3) or ints:
        bad.append(f"the card's merge from the CPU's: Sim3 {sim3_diff}, poses {pose_diff}, "
                   f"integer fields differ: {ints}")
    if bad:
        _fail("merge, card against CPU: " + "; ".join(bad))

    # the same try_merge on the card: its stages alone by CUDA events, then
    # kernels and device time under the profiler, then its blocking reads
    g, ff_g = _merge_system(snap, dev)
    calls = {}
    spied = [(map_merging.matching, "match_nn"), (map_merging.sim3solver, "solve_sim3"),
             (map_merging.atlas_mod, "merge_maps"), (map_merging.atlas_mod, "splice_banks")]
    orig = [getattr(mod, name) for mod, name in spied]

    def keep(name, fn):
        def wrapper(*a, **kw):
            calls.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapper

    for (mod, name), fn in zip(spied, orig):
        setattr(mod, name, keep(name, fn))
    merge_ba = g._merge_ba
    g._merge_ba = keep("welding_ba", merge_ba)
    try:
        run(g, ff_g, snap["ki"], idx_fn=loop_scene.fixed_samples)
    finally:
        for (mod, name), fn in zip(spied, orig):
            setattr(mod, name, fn)
    sess = snap["sessions"][lm_g["session"]]
    lc = g.loop_closer
    merged = g.map
    valid = np.nonzero(merged.kf_valid[:g.n_kf_host].cpu().numpy())[0].tolist()
    bank = g.bank
    (mm_a, mm_kw), (s3_a, s3_kw) = calls["match_nn"], calls["solve_sim3"]
    mg_a, sp_a, ba_a = calls["merge_maps"][0], calls["splice_banks"][0], calls["welding_ba"][0]

    sess_db = _to(sess.db, dev)

    def rebuild():
        lc.db = kdb.clear(lc.db)
        for k in valid:
            lc.add_keyframe(merged, k, fb.frame_view(bank, k))

    stages = {
        "query": (lambda: kdb.query(sess_db, lc._bow(ff_g.desc, ff_g.valid)[0]), 5),
        "match_nn": (lambda: matching.match_nn(*mm_a, **mm_kw), 5),
        "solve_sim3": (lambda: sim3solver.solve_sim3(*s3_a, **s3_kw), 5),
        "merge_maps + splice_banks": (
            lambda: (atlas.merge_maps(*mg_a), atlas.splice_banks(*sp_a)), 5),
        "welding_ba": (lambda: merge_ba(*ba_a), 3),
        "database_rebuild": (rebuild, 3)}
    timed = {name: _event_ms(fn, runs=runs) for name, (fn, runs) in stages.items()}
    g2, ff2 = _merge_system(snap, dev)
    with profile_keyframe.DeviceWork() as w:
        run(g2, ff2, snap["ki"], idx_fn=loop_scene.fixed_samples)
    g3, ff3 = _merge_system(snap, dev)
    found = []
    with sync_census._sync_warnings(found):
        run(g3, ff3, snap["ki"], idx_fn=loop_scene.fixed_samples)
    return dict(stats=st, drive_s=drive_s, attempts=seen["attempts"], host_ms=seen["host_ms"],
                cpu_ms=cpu_ms, sim3_diff=sim3_diff, pose_diff=pose_diff, stages=timed,
                launches=w.launches, device_ms=w.device_ms, reads=len(found),
                read_sites=collections.Counter(found), system=sys_, drive=d)


def gnss_phase(scfg, frames, dev) -> dict:
    """Phase 10b: bench.py's 78 frames with a GNSS fix before each
    (`atlas_scene.drive_gnss`); the first GNSS BA again on the CPU from its
    inputs; the GNSS stage by CUDA events and its blocking reads per
    keyframe frame that ran it; the GNSS BA alone by events and under the
    profiler.  Raises on a failed gate."""
    import torch
    from orbslam3_tpu_torch.pipeline import system
    from orbslam3_tpu_torch.utils import atlas_scene, profile_keyframe, sync_census

    ba_run, stage_run = system.gnss_ba, system.System._gnss_keyframe_stage
    seen, stage_ev, stage_host = {}, [], []
    found, frame_reads = [], {}

    def ba_spy(*a, **kw):
        out = ba_run(*a, **kw)
        seen.setdefault("first", (a, kw, out))
        return out

    def stage_spy(self, ki, ts):
        n0 = self.n_gnss_ba
        t0 = time.perf_counter()
        out = _events(stage_ev, stage_run)(self, ki, ts)
        stage_host.append((time.perf_counter() - t0, self.n_gnss_ba > n0))
        return out

    class Frame:
        """Counts the frame's blocking reads by `atlas_frame_kind`."""
        def __init__(self, fi, s_):
            self.s_ = s_

        def __enter__(self):
            found.clear()
            s_ = self.s_
            self.before = (s_.state, s_.n_kf_host, s_.last_merge, s_.n_gnss_ba)

        def __exit__(self, *exc):
            kind = profile_keyframe.atlas_frame_kind(self.s_, *self.before)
            frame_reads.setdefault(kind, []).append(len(found))
            return False

    system.gnss_ba, system.System._gnss_keyframe_stage = ba_spy, stage_spy
    t0 = time.perf_counter()
    try:
        with sync_census._sync_warnings(found):
            sys_, d, gt = atlas_scene.drive_gnss(scfg, frames, dev, wrap=Frame)
    finally:
        system.gnss_ba, system.System._gnss_keyframe_stage = ba_run, stage_run
    drive_s = time.perf_counter() - t0
    bad, st = atlas_scene.check_gnss_gates(sys_, d, gt)
    if bad:
        _fail("GNSS gates failed: " + "; ".join(bad))
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # the first GNSS BA on the CPU from the same inputs: keyframe centres
    # within 1e-3 of the map's extent (the priors fix the gauge)
    a, kw, out = seen["first"]
    cfg, cam, m, ki, pp, pw, bank = a
    t0 = time.perf_counter()
    ref = ba_run(cfg, cam.cpu(), _to(m, "cpu"), ki, pp.cpu(), pw.cpu(), _to(bank, "cpu"))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    nk = int(m.n_kf)
    centre = lambda mm: (-mm.kf_R[:nk].transpose(1, 2) @ mm.kf_t[:nk, :, None])[..., 0].cpu()
    ok = ref.pt_valid
    extent = float(ref.pt_xyz[ok].abs().max())
    centre_diff = float((centre(out) - centre(ref)).abs().max()) / extent
    pt_diff = float((out.pt_xyz.cpu()[ok] - ref.pt_xyz[ok]).abs().max()) / extent
    if not centre_diff < 1e-3:
        _fail(f"the card's first GNSS BA from the CPU's: keyframe centres {centre_diff} of the "
              f"extent (points {pt_diff})")
    ba_ms = _event_ms(lambda: ba_run(*a, **kw), runs=3)
    durs, per_call = profile_keyframe.kernel_durations(lambda: ba_run(*a, **kw), [""], runs=1)
    return dict(stats=st, drive_s=drive_s, cpu_ms=cpu_ms, centre_diff=centre_diff,
                pt_diff=pt_diff, ba_ms=ba_ms, ba_launches=per_call,
                ba_device_ms=sum(durs[""]) / 1e3, stage_ms=_ms(stage_ev),
                stage_host_ms=[(s * 1e3, posted) for s, posted in stage_host],
                frame_reads=frame_reads, n_kf_ba=nk, system=sys_)


def checkpoint_phase(sys_a, scfg, dev) -> dict:
    """Phase 10c: 10a's merged System saved, loaded into a fresh System on
    the card and one on the CPU (the two maps, banks and databases equal),
    12 more frames of the path on the card (no reset, no keyframe slot
    overwritten), and a frame from frame 10's viewpoint relocalized by a
    third System loaded on the card against the restored database.  Raises
    on a failed gate."""
    import tempfile

    import numpy as np
    import torch
    from orbslam3_tpu_torch.features import extractor
    from orbslam3_tpu_torch.pipeline import relocalization, system
    from orbslam3_tpu_torch.slam_map import checkpoint
    from orbslam3_tpu_torch.utils import profile_keyframe
    from orbslam3_tpu_torch.utils import seeded_scene as scene

    out, bad = {}, []
    more = dataclasses.replace(scfg, track_frames=tuple(range(78, 90)))
    frames = scene.render_frames(more)
    revisit = scene.render_revisit(scfg, [10])[10]
    nk, last_ts = sys_a.n_kf_host, sys_a.last_kf_ts
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/merged.npz"
        with profile_keyframe.DeviceWork() as w:
            t0 = time.perf_counter()
            checkpoint.save_system(path, sys_a)
        out["save_ms"], out["save_launches"] = (time.perf_counter() - t0) * 1e3, w.launches
        loaded, out["load_ms"] = [], []
        for device in ("cpu", dev, dev):
            s_ = system.System(sys_a.cfg, device=device)
            with profile_keyframe.DeviceWork() if device != "cpu" else contextlib.nullcontext() \
                    as w:
                t0 = time.perf_counter()
                checkpoint.load_system(path, s_)
            loaded.append(s_)
            out["load_ms"].append((time.perf_counter() - t0) * 1e3)
            if w is not None:
                out["load_launches"], out["load_device_ms"] = w.launches, w.device_ms
        out["file_bytes"] = sum(os.path.getsize(p) for p in (path, path + ".extras.pkl"))
    c, g, g3 = loaded
    diff = [f for f, x in c.map._asdict().items() if not torch.equal(getattr(g.map, f).cpu(), x)]
    diff += [f"bank.{f}" for f, x in c.bank._asdict().items()
             if not torch.equal(getattr(g.bank, f).cpu(), x)]
    diff += [f"database.{f}" for f, x in c.loop_closer.db._asdict().items()
             if not torch.equal(getattr(g.loop_closer.db, f).cpu(), x)]
    if diff:
        bad.append(f"the card's and the CPU's loaded states differ in {diff}")
    if (g.n_kf_host, g.state) != (nk, system.OK) or abs(g.last_kf_ts - last_ts) > 1e-5:
        bad.append(f"restored {g.n_kf_host} keyframes, state {g.state}, last ts {g.last_kf_ts}")
    drive = scene.drive_system(more, frames, dev, sys_=g)[1]
    kf_ts_ok = torch.equal(g.map.kf_ts[:nk], sys_a.map.kf_ts[:nk])
    if g.state != system.OK or g.n_resets or g.n_kf_host < nk or not kf_ts_ok:
        bad.append(f"continued: state {g.state}, {g.n_resets} resets, {g.n_kf_host} keyframes "
                   f"of {nk}, first timestamps intact {kf_ts_ok}")
    ff = extractor.extract(torch.from_numpy(revisit).to(dev), g3.cfg.orb)
    t0 = time.perf_counter()
    ok, R, t = relocalization.attempt_relocalization(g3, ff, g3.loop_closer)
    out["reloc_ms"] = (time.perf_counter() - t0) * 1e3
    _, scale, _ = scene.system_ate(sys_a)
    first = next(p for p in sys_a.trajectory if abs(p[0] - 1.0) < 1e-6)
    err = float(np.linalg.norm(-R.cpu().numpy().T @ t.cpu().numpy() - first[2])) * scale if ok \
        else float("nan")
    if not err <= 0.05:
        bad.append(f"frame 10 relocalized {ok}, centre {err} world units from its pose")
    if bad:
        _fail("checkpoint gates failed: " + "; ".join(bad))
    out.update(n_kf=nk, n_kf_after=g.n_kf_host, frames=len(drive.frames),
               frame_ms=statistics.median(drive.seconds) * 1e3, reloc_err=err, n_extract=13)
    return out


def atlas_phase(scfg, frames, dev) -> dict:
    """Phase 10: 10a, 10b and 10c, each timed on the host clock."""
    out = {}
    for part, fn in (("merge", lambda: merge_phase(scfg, frames, dev)),
                     ("gnss", lambda: gnss_phase(scfg, frames, dev)),
                     ("checkpoint", lambda: checkpoint_phase(out["merge"]["system"], scfg, dev))):
        t0 = time.perf_counter()
        out[part] = fn()
        out[part]["part_s"] = time.perf_counter() - t0
    return out


def print_atlas(ap: dict) -> None:
    """Phase 10's lines."""
    m, gn, ck = ap["merge"], ap["gnss"], ap["checkpoint"]
    st, mg = m["stats"], m["stats"]["merge"]
    print(f"atlas 10a ({m['part_s']:.1f} s): bench.py's 78 frames, 30-33 blank, with loop "
          f"closing in {m['drive_s']:.1f} s: reset at frame {st['reset_frame']}, the second map "
          f"merged at frame {st['merge_frame']} (its keyframe {mg['kf']} with the session's "
          f"keyframe {mg['cand']}: {mg['n_matches']} matches, {mg['n_inliers']} Sim3 inliers, "
          f"scale {st['scale_sim3']:.5g}; offsets {mg['kf_off']} / {mg['pt_off']}) after "
          f"{m['attempts']} attempts, OK from the merge on, {st['per_session']} valid keyframes "
          f"per session, {st['n_points']} points, merged trajectory {st['n_traj']} frames, ATE "
          f"{st['ate']:.5g} ({st['ate'] / st['span']:.4f} of the span), merge edge persisted; "
          f"the CPU copy merged the same (Sim3 within {m['sim3_diff']:.3g}, poses within "
          f"{m['pose_diff']:.3g}, integer fields equal; {m['cpu_ms']:.1f} ms on the CPU); "
          f"try_merge {m['host_ms']:.1f} ms on the host clock, {m['launches']} kernels, "
          f"{m['device_ms']:.3f} ms of device time, {m['reads']} blocking reads", flush=True)
    for name, ms in m["stages"].items():
        print(f"  {name}: {ms:.3f} ms (CUDA events)", flush=True)
    print(f"  reads: {dict(m['read_sites'])}", flush=True)
    g = gn["stats"]
    reads = {k: statistics.mean(v) for k, v in gn["frame_reads"].items()}
    print(f"atlas 10b ({gn['part_s']:.1f} s): bench.py's 78 frames with GNSS fixes in "
          f"{gn['drive_s']:.1f} s: "
          f"georeference initialized (scale {g['geo_scale']:.5g}), {g['n_fixes']} keyframes "
          f"with a fix, {g['n_gnss_ba']} GNSS BAs posted, {g['merged']} merged, geo RMSE "
          f"{g['geo_rmse']:.5g} (< 0.5), 0 resets, every pose finite; the first GNSS BA "
          f"({gn['n_kf_ba']} keyframes) on the CPU from its inputs: keyframe centres within "
          f"{gn['centre_diff']:.3g} of the extent, points {gn['pt_diff']:.3g} "
          f"({gn['cpu_ms']:.1f} ms on the CPU); GNSS BA alone {gn['ba_ms']:.3f} ms (CUDA "
          f"events), {gn['ba_launches']} kernels, {gn['ba_device_ms']:.3f} ms of device time; "
          f"GNSS stage {['%.3f' % x for x in gn['stage_ms']]} ms by events, on the host "
          f"{['%.1f%s' % (s, '*' if p else '') for s, p in gn['stage_host_ms']]} ms (* posted "
          f"a BA); blocking reads per frame {reads}", flush=True)
    print(f"atlas 10c ({ck['part_s']:.1f} s): save {ck['save_ms']:.1f} ms ({ck['file_bytes']} bytes, "
          f"{ck['save_launches']} kernels), load {ck['load_ms'][0]:.1f} ms on the CPU, "
          f"{ck['load_ms'][1]:.1f} | {ck['load_ms'][2]:.1f} ms on the card (the last: "
          f"{ck['load_launches']} kernels, {ck['load_device_ms']:.3f} ms of device time); the "
          f"card's and the CPU's restored maps, banks and databases equal; {ck['frames']} more "
          f"frames OK on the card (median {ck['frame_ms']:.3f} ms), 0 resets, keyframes "
          f"{ck['n_kf']} -> {ck['n_kf_after']}, none overwritten; frame 10 relocalized against "
          f"the restored database, centre {ck['reloc_err']:.4g} world units from its pose "
          f"({ck['reloc_ms']:.1f} ms)", flush=True)


class _FrameKinds:
    """`sensor_scene.drive` hooks for phase 11: each frame's kind
    (`sensor_scene.frame_kind`), its blocking reads (the sites that
    `sync_census._sync_warnings` appends to `found`), and one profiled frame
    (`profile_keyframe.DeviceWork`) of each kind that `expected(fi, sys_)`
    foresees, from frame 10 on."""

    def __init__(self, expected, found: list):
        self.expected, self.found = expected, found
        self.kinds: dict = {}          # kind -> positions in the drive
        self.reads: dict = {}          # kind -> [reads per unprofiled frame]
        self.sites: dict = {}          # kind -> Counter of read sites
        self.profiled: dict = {}       # kind -> DeviceWork
        self._work = None
        self._n = 0

    def wrap(self, fi, sys_):
        from orbslam3_tpu_torch.utils import profile_keyframe
        self.found.clear()
        kind = self.expected(fi, sys_)
        self._work = None
        if kind is not None and kind not in self.profiled and fi >= 10:
            self._work = profile_keyframe.DeviceWork(kind)
        return self._work

    def on_frame(self, fi, sys_, was, was_init, n_kf):
        from orbslam3_tpu_torch.utils import sensor_scene as ss
        kind = ss.frame_kind(sys_, was, was_init, n_kf)
        self.kinds.setdefault(kind, []).append(self._n)
        self._n += 1
        w = self._work
        if w is not None:
            w.frame = fi
            if w.kind == kind:
                self.profiled[kind] = w
            return
        self.reads.setdefault(kind, []).append(len(self.found))
        self.sites.setdefault(kind, collections.Counter()).update(self.found)

    def summary(self, seconds: list) -> dict:
        prof = {w.frame for w in self.profiled.values()}
        out = {}
        for kind, pos in self.kinds.items():
            secs = [seconds[n] for n in pos if n not in prof] or [seconds[n] for n in pos]
            w = self.profiled.get(kind)
            reads = self.reads.get(kind, [])
            out[kind] = dict(frames=len(pos), median_ms=statistics.median(secs) * 1e3,
                             launches=None if w is None else w.launches,
                             device_ms=None if w is None else w.device_ms,
                             profiled_frame=None if w is None else w.frame,
                             reads=statistics.mean(reads) if reads else None,
                             sites=dict(self.sites.get(kind, collections.Counter()).most_common(4)))
        return out


def _expected_depth_kind(fi, sys_):
    """The kind that a depth sensor's or a monocular System's next frame
    should turn out to be (None before initialization)."""
    from orbslam3_tpu_torch.pipeline import system
    if sys_.state != system.OK:
        return None
    gap = sys_.frame_id + 1 - sys_.last_kf_id
    return "keyframe frame" if gap >= sys_.cfg.max_frames_between_kf else "tracked frame"


def first_pair_check(slam, scfg, img_l, img_r, dev) -> dict:
    """11a's first pair: its depths on the card, then the stereo
    initialization on the card and on a CPU copy of the same keypoints and
    depths.  The same points from the same keypoints in the same slots, the
    same observations, positions within 1e-4 relative; raises otherwise."""
    import torch
    from orbslam3_tpu_torch.pipeline import stereo_system

    slam = dataclasses.replace(slam, enable_relocalization=False)
    card = stereo_system.StereoSystem(slam, scfg, device=dev)
    cpu = stereo_system.StereoSystem(slam, scfg, device="cpu")
    ff = card._pair_depth(img_l, img_r, None, None)
    cpu._depth = _to(card._depth, "cpu")
    for sys_, f in ((card, ff), (cpu, _to(ff, "cpu"))):
        sys_.frame_id = 0
        sys_._stereo_initialize(f, 0.0)
    a, b = card.map, cpu.map
    bad = [n for n in ("n_pt", "n_obs", "pt_valid", "obs_pt", "obs_kf", "obs_valid", "pt_desc")
           if not torch.equal(getattr(a, n).cpu(), getattr(b, n))]
    if not torch.equal(card.bank.kp_pt.cpu(), cpu.bank.kp_pt):
        bad.append("bindings")
    v = b.pt_valid
    rel = float(((a.pt_xyz.cpu() - b.pt_xyz).norm(dim=1)[v] / b.pt_xyz.norm(dim=1)[v]).max())
    if bad or not rel <= 1e-4 or int(b.n_pt) < 100:
        _fail(f"11a's first pair: card and CPU differ in {bad}, points within {rel:.3g}, "
              f"{int(b.n_pt)} points")
    return dict(n_points=int(b.n_pt), rel=rel)


def sensors_phase(scfg, sframes, dev) -> dict:
    """Phase 11 on device `dev`: (a) the stereo, (b) the RGB-D, (c) the
    raw-fisheye stereo-inertial and (d) the KB8 monocular System, each
    driven through its entry point with its gates (`utils/sensor_scene.py`),
    the launch counters set to 0 just before each drive and read just
    after; raises on a failed gate.  Returns the parts' numbers."""
    import torch
    from orbslam3_tpu_torch.ops import orb_patches
    from orbslam3_tpu_torch.pipeline import (rgbd_system, stereo_inertial_system,
                                             stereo_system, system)
    from orbslam3_tpu_torch.utils import imu_scene
    from orbslam3_tpu_torch.utils import seeded_scene as scene
    from orbslam3_tpu_torch.utils import sensor_scene as ss
    from orbslam3_tpu_torch.utils import sync_census

    t0 = time.perf_counter()
    fcfg = ss.fisheye_config()
    si = ss.FisheyeSIScene(frames=FISHEYE_SI_SMOKE_FRAMES)
    # the four renders are independent and numpy releases the GIL: they overlap
    with ThreadPoolExecutor(4) as ex:
        jobs = [ex.submit(ss.render_right_frames, scfg), ex.submit(ss.depth_images, scfg),
                ex.submit(ss.render_fisheye_frames, scfg, fcfg), ex.submit(si.render)]
        right, depth, fish, si_imgs = (j.result() for j in jobs)
    out = {"render_s": time.perf_counter() - t0}
    slam, st = ss.stereo_configs(scfg)
    out["first_pair"] = first_pair_check(slam, st, sframes[scfg.track_frames[0]],
                                         right[scfg.track_frames[0]], dev)
    n = len(scfg.track_frames)
    si_cfg = si.configs()

    def fish_gates(sys_, d):
        return scene.check_system_gates(sys_, scene.SystemDrive(*d[:6]),
                                        init_by=ss.FISHEYE_INIT_BY,
                                        max_ate_ratio=ss.FISHEYE_MAX_ATE_RATIO)

    parts = (
        ("stereo", lambda: stereo_system.StereoSystem(slam, st, device=dev),
         ss.stereo_step(sframes, right), scfg.track_frames, 2 * n, _expected_depth_kind,
         lambda s_, d: ss.check_depth_gates(s_, d, ss.STEREO_MAX_ATE, ss.STEREO_MAX_SCALE_ERR)),
        ("rgbd", lambda: rgbd_system.RGBDSystem(slam, st, device=dev),
         ss.rgbd_step(sframes, depth), scfg.track_frames, n, _expected_depth_kind,
         lambda s_, d: ss.check_depth_gates(s_, d, ss.RGBD_MAX_ATE, ss.RGBD_MAX_SCALE_ERR)),
        ("stereo_inertial",
         lambda: stereo_inertial_system.StereoInertialSystem(*si_cfg, device=dev),
         ss.fisheye_si_step(si, si_imgs), range(si.frames), 2 * si.frames,
         lambda fi, s_: imu_scene.expected_kind(s_, fi),
         lambda s_, d: ss.check_fisheye_si_gates(si, s_, d)),
        ("kb8_mono", lambda: system.System(fcfg, device=dev), ss.mono_step(fish),
         scfg.track_frames, n, _expected_depth_kind, fish_gates),
    )
    found: list = []
    for name, make, step, frames, n_extract, expected, gates in parts:
        t0 = time.perf_counter()
        sys_ = make()
        fk = _FrameKinds(expected, found)
        orb_patches.reset_counters()
        with sync_census._sync_warnings(found):
            d = ss.drive(sys_, frames, step, sync=torch.cuda.synchronize, wrap=fk.wrap,
                         on_frame=fk.on_frame)
        launches = orb_patches.launch_counts()
        bad, stats = gates(sys_, d)
        if launches != orb_patches.path_counts(n_extract):
            bad.append(f"launch counters {launches} for {n_extract} extractions")
        for what, tensor in (("map", sys_.map.pt_xyz), ("bank", sys_.bank.xy)):
            if tensor.device.type != "cuda":
                bad.append(f"the {what} is on {tensor.device}")
        if bad:
            _fail(f"sensors 11 {name}: " + "; ".join(bad))
        out[name] = dict(stats=stats, launches=launches, kinds=fk.summary(d.seconds),
                         frames=len(d.frames), drive_s=sum(d.seconds),
                         part_s=time.perf_counter() - t0)
        del sys_
    return out


def print_sensors(sp: dict) -> None:
    """Phase 11's lines."""
    fp = sp["first_pair"]
    labels = {"stereo": "11a stereo (bench.py's 78 frames as rectified pairs, b = 0.110074)",
              "rgbd": "11b RGB-D (the 78 left frames and the plane's depth)",
              "stereo_inertial": f"11c raw-fisheye stereo-inertial (TUM-VI camera, "
                                 f"{FISHEYE_SI_SMOKE_FRAMES} of the test's 70 frames)",
              "kb8_mono": "11d KB8 monocular (TUM-VI camera, bench.py's 78 frames)"}
    print(f"sensors: rendering {sp['render_s']:.1f} s; 11a's first pair on the card and on "
          f"the CPU: the same {fp['n_points']} points, positions within {fp['rel']:.3g} "
          f"relative", flush=True)
    for name, label in labels.items():
        p = sp[name]
        st = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in p["stats"].items()}
        print(f"sensors {label}: {p['frames']} frames in {p['drive_s']:.1f} s (part "
              f"{p['part_s']:.1f} s); gates held: {st}; launches {p['launches']}", flush=True)
        for kind, k in p["kinds"].items():
            la = "not measured" if k["launches"] is None else f"{k['launches']} kernels"
            dm = "" if k["device_ms"] is None else f", {k['device_ms']:.2f} ms of device time"
            rd = "n/a" if k["reads"] is None else f"{k['reads']:.2f}"
            print(f"  {kind}: {k['frames']} frames, median {k['median_ms']:.1f} ms on the host "
                  f"clock; frame {k['profiled_frame']} profiled: {la}{dm}; blocking reads per "
                  f"frame {rd} {k['sites']}", flush=True)


# phase 12's arms: (mode, metric scale, extractions per frame).  Each runs
# the tree's 60 frames: the five take ~100 s on the card, so none is cut.
EUROC_ARMS = (("mono", False, 1), ("stereo", True, 2), ("rgbd", True, 1),
              ("mono-inertial", False, 1), ("stereo-inertial", True, 2))


# the CLAHE the native ingest is held to in phase 12: (clip, grid) and the
# frames of each camera; 12c's arm runs the runner's `--clahe` at that clip
# (the option TUM-VI's users turn on; the runner's grid is 8)
INGEST_CLAHE, INGEST_CLAHE_FRAMES = (3.0, 8), 4
TUMVI_CLAHE = INGEST_CLAHE[0]


def euroc_ingest_check(root, cam=None, umap=None, sub: str = "cam0") -> dict:
    """One camera of a tree (12a: EuRoC's cam0 through its undistortion map;
    12c: TUM-VI's cam0 and cam1 through their rectification maps) through
    the host path (`load_image` + `apply_undistort`) and the native ingest,
    which must build (on a host without libpng headers PIL feeds it); their
    frames must agree within test_io.py's oracle tolerance (0.3 graylevels
    anywhere, 1e-3 where the map's source pixel lies inside the image).
    Then its first `INGEST_CLAHE_FRAMES` frames with CLAHE (`INGEST_CLAHE`)
    against the plain stages (`io/ingest_ref.py`) under test_io.py's CLAHE
    tolerance: within 1.5 graylevels away from the bin edges
    (`ingest_ref.clahe_gaps`), 0.1 on average.  Returns the decoder, ms
    per frame of each decoder and the differences."""
    import numpy as np
    from orbslam3_tpu_torch.io import euroc, ingest_ref, native_ingest

    if not native_ingest.available():
        _fail(f"euroc ingest {sub}: the native ingest does not build: "
              f"{native_ingest.build_error()}")
    seq = euroc.EurocSequence(root, cam=sub)
    cam = cam or euroc.EUROC_CAM0
    hw = cam["resolution"]
    if umap is None:
        umap = euroc.undistort_map(cam["params"], cam["distortion"], hw)
    paths = [r.path for r in seq.images]
    t0 = time.perf_counter()
    host = [euroc.apply_undistort(seq.load_image(r), umap) for r in seq.images]
    out = dict(decoder=native_ingest.decoder(),
               host_ms=(time.perf_counter() - t0) / len(host) * 1e3, n=len(host))
    t0 = time.perf_counter()
    got = list(native_ingest.NativeIngest(paths, hw, umap, src_hw=hw))
    out["native_ms"] = (time.perf_counter() - t0) / len(got) * 1e3
    if len(got) != len(host):
        _fail(f"euroc ingest {sub}: the native ingest gave {len(got)} of {len(host)} frames")
    d = np.stack([np.abs(a - b) for a, b in zip(got, host)])
    inner = (umap[..., 0] >= 1) & (umap[..., 0] <= hw[1] - 2) & \
        (umap[..., 1] >= 1) & (umap[..., 1] <= hw[0] - 2)
    out["max_diff"], out["inner_diff"] = float(d.max()), float(d[:, inner].max())
    if out["max_diff"] > 0.3 or out["inner_diff"] > 1e-3:
        _fail(f"euroc ingest {sub}: native and host frames differ by {out['max_diff']} "
              f"({out['inner_diff']} inside)")
    clip, grid = INGEST_CLAHE
    eq = list(native_ingest.NativeIngest(paths[:INGEST_CLAHE_FRAMES], hw, umap, src_hw=hw,
                                         clahe_clip=clip, clahe_grid=grid))
    gaps = [ingest_ref.clahe_gaps(e, seq.load_image(r), umap, clahe_clip=clip, clahe_grid=grid)
            for e, r in zip(eq, seq.images)]
    out["clahe"] = {k: max(g[k] for g in gaps) for k in ("max", "mean", "max_off_edge", "n_edge")}
    if len(eq) != INGEST_CLAHE_FRAMES or not (out["clahe"]["max_off_edge"] < 1.5
                                              and out["clahe"]["mean"] < 0.1):
        _fail(f"euroc ingest {sub}: {len(eq)} CLAHE frames, against ingest_ref {out['clahe']}")
    return out


@contextlib.contextmanager
def host_decoder():
    """The runner and the pump take the host decoder (`load_image` +
    `apply_undistort`), as where the native ingest does not build."""
    from unittest import mock
    from orbslam3_tpu_torch.io import native_ingest
    with mock.patch.object(native_ingest, "available", return_value=False), \
            mock.patch.object(native_ingest, "build_error",
                              return_value="set aside to time the host decoder"):
        yield


def runner_arm(root, argv: list, label: str, metric: bool, per_frame: int, n: int,
               span: float, dev, host: bool = False) -> dict:
    """One arm of the sequence runner: `run_euroc.main(argv)` on device
    `dev` (on the host decoder where `host`, else on the native ingest,
    which its first line must name) with the launch counters set to 0 just
    before it and read just after, under TestRunEurocTool's gates (every
    frame processed, 0 resets,
    more than 60% of the frames in the TUM file, ATE below 0.15 of `span`,
    for a metric arm |scale - 1| below 0.1), `orb_describe` `per_frame`
    times per frame, the map and the bank on `dev`; raises on a failed gate.
    Returns its numbers: fps, keyframes, the ATE line, the wait for the
    images, per frame kind the host-clock median and the blocking reads
    with their sites (frame 0 left out: its reads include the System's
    construction), and whether the IMU initialized (and at which frame)."""
    import io
    from orbslam3_tpu_torch.ops import orb_patches
    from orbslam3_tpu_torch.tools import run_euroc
    from orbslam3_tpu_torch.utils import sensor_scene as ss
    from orbslam3_tpu_torch.utils import sync_census

    traj = os.path.join(root, f"traj_{label.replace(' ', '_')}.txt")
    found: list = []
    rec = dict(kinds=collections.defaultdict(list), reads=collections.defaultdict(list),
               sites=collections.defaultdict(collections.Counter), ingest=[], imu_frame=[])

    def on_frame(i, sys_, before, track_s, ingest_s):
        kind = ss.frame_kind(sys_, *before)
        rec["kinds"][kind].append(track_s)
        rec["ingest"].append(ingest_s)
        if i > 0:        # frame 0's reads include the System's construction
            rec["reads"][kind].append(len(found))
            rec["sites"][kind].update(found)
        if getattr(sys_, "imu_initialized", False) and not rec["imu_frame"]:
            rec["imu_frame"].append(i)
        found.clear()

    argv = argv + ["--out", traj] + ([] if dev.type == "cuda" else ["--device", str(dev)])
    buf = io.StringIO()
    t0 = time.perf_counter()
    orb_patches.reset_counters()
    with contextlib.redirect_stdout(buf), sync_census._sync_warnings(found), \
            (host_decoder() if host else contextlib.nullcontext()):
        res = run_euroc.main(argv, on_frame=on_frame)
    launches = orb_patches.launch_counts()
    arm_s = time.perf_counter() - t0
    text = buf.getvalue()
    sys_ = res["system"]
    n_run = len(rec["ingest"])
    bad = []
    first = "ingest: host (" if host else "ingest: native ("
    if not text.startswith(first):
        bad.append(f"the first line reads {text.splitlines()[:1]}, not {first}...)")
    if f"processed {n} frames" not in text or n_run != n:
        bad.append(f"processed {n_run} of {n} frames")
    if sys_.n_resets != 0 or "resets=0" not in text:
        bad.append(f"{sys_.n_resets} resets")
    n_traj = len([ln for ln in open(traj).read().splitlines() if ln])
    if n_traj <= 0.6 * n:
        bad.append(f"{n_traj} of {n} frames in the TUM file")
    r = res["ate"]
    if r is None or not r["rmse"] < 0.15 * span:
        bad.append(f"ATE {None if r is None else r['rmse']} against a span of {span}")
    elif metric and not abs(r["scale"] - 1.0) < 0.1:
        bad.append(f"scale {r['scale']}")
    want = orb_patches.path_counts(per_frame * n_run)
    if launches != want:
        bad.append(f"launch counters {launches} for {per_frame * n_run} extractions")
    for what, tensor in (("map", sys_.map.pt_xyz), ("bank", sys_.bank.xy)):
        if tensor.device != dev:
            bad.append(f"the {what} is on {tensor.device}")
    if bad:
        _fail(f"euroc {label}: " + "; ".join(bad) + "\n" + text)
    lines = text.splitlines()
    return dict(
        n=n, launches=launches, arm_s=arm_s, wall=res["wall"], fps=n / res["wall"],
        decoder=lines[0], ate_line=next(ln for ln in lines if ln.startswith("ATE:")),
        ate=r["rmse"], scale=r["scale"], span=span, n_kf=sys_.n_kf_host, n_traj=n_traj,
        ingest_ms=statistics.median(rec["ingest"]) * 1e3,
        imu_initialized=getattr(sys_, "imu_initialized", None),
        imu_frame=rec["imu_frame"][0] if rec["imu_frame"] else -1,
        kinds={k: dict(frames=len(v), median_ms=statistics.median(v) * 1e3,
                       reads=statistics.mean(rec["reads"][k]) if rec["reads"][k] else None,
                       sites=dict(rec["sites"][k].most_common(4)))
               for k, v in rec["kinds"].items()})


def euroc_phase(dev) -> dict:
    """Phase 12 on device `dev`: the EuRoC-layout tree of
    tests/test_euroc_tool.py written at full width (`utils/euroc_scene`),
    its decoders held together (12a), then the sequence runner's five arms
    through `run_euroc.main` on the card, the mono arm again on the host
    decoder (12b, `runner_arm`); then the TUM-VI-layout tree
    (`utils/tumvi_scene`) at 512x512, its cam0 and cam1 through both
    decoders with the preset's rectification maps, and the runner's
    `--dataset tumvi --mode stereo-inertial --clahe 3.0` arm at the
    preset's 1000 features (12c).  Raises on a failed gate; returns the numbers."""
    from orbslam3_tpu_torch import config as presets
    from orbslam3_tpu_torch.io import euroc
    from orbslam3_tpu_torch.utils import euroc_scene as es
    from orbslam3_tpu_torch.utils import tumvi_scene as ts

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orbslam3_tpu_torch",
                         "build")
    root = os.path.join(build, f"euroc_seq_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        es.write_tree(root, es.N_FRAMES)
        out = {"tree_s": time.perf_counter() - t0, "ingest": euroc_ingest_check(root)}
        n = es.N_FRAMES
        for mode, metric, per_frame in EUROC_ARMS:
            out[mode] = runner_arm(root, [root, "--mode", mode], f"12b {mode}", metric,
                                   per_frame, n, es.span(n), dev)
            if mode == "mono":
                # the same arm on the host decoder, right after: PIL's decode
                # threads would show in the tracked frames' median
                out["mono_host"] = runner_arm(root, [root, "--mode", mode],
                                              "12b mono host", metric, per_frame, n,
                                              es.span(n), dev, host=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = os.path.join(build, f"tumvi_seq_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        ts.write_tree(root, ts.N_FRAMES)
        tv = {"tree_s": time.perf_counter() - t0}
        *_, map0, map1 = presets.tumvi_stereo_inertial()
        for sub, cam, umap in (("cam0", euroc.TUMVI_CAM0, map0),
                               ("cam1", euroc.TUMVI_CAM1, map1)):
            tv["ingest_" + sub] = euroc_ingest_check(root, cam, umap, sub)
        n = ts.N_FRAMES
        tv.update(runner_arm(root, [root, "--dataset", "tumvi", "--mode", "stereo-inertial",
                                    "--features", "1000", "--clahe", str(TUMVI_CLAHE)],
                             "12c tumvi stereo-inertial", True, 2, n, ts.span(n), dev))
        out["tumvi_stereo_inertial"] = tv
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _print_arm(label: str, a: dict) -> None:
    imu = "" if a["imu_initialized"] is None else \
        (f"; the IMU initialized at frame {a['imu_frame']}" if a["imu_initialized"]
         else "; the IMU not initialized")
    print(f"euroc {label}: {a['decoder']}; {a['n']} frames in {a['wall']:.1f} s "
          f"({a['fps']:.2f} fps; arm {a['arm_s']:.1f} s), 0 resets, {a['n_kf']} "
          f"keyframes, {a['n_traj']} poses in the TUM file; {a['ate_line']} (span "
          f"{a['span']:.3f}){imu}; waiting for the images {a['ingest_ms']:.2f} ms per frame "
          f"(median); launches {a['launches']}", flush=True)
    for kind, k in a["kinds"].items():
        rd = "n/a" if k["reads"] is None else f"{k['reads']:.2f}"
        print(f"  {kind}: {k['frames']} frames, median {k['median_ms']:.1f} ms on the "
              f"host clock; blocking reads per frame {rd} {k['sites']}", flush=True)


def _print_ingest(ig: dict) -> str:
    c = ig["clahe"]
    return (f"native ingest ({ig['decoder']}) {ig['native_ms']:.2f} ms per frame against the "
            f"host path's {ig['host_ms']:.2f} ms, frames within {ig['max_diff']:.3g} "
            f"({ig['inner_diff']:.3g} inside the map's source); {INGEST_CLAHE_FRAMES} frames "
            f"with CLAHE {INGEST_CLAHE} against ingest_ref: within {c['max_off_edge']:.3g} "
            f"off the bin edges ({c['max']:.3g} on {c['n_edge']} edge pixels), mean "
            f"{c['mean']:.3g}")


def print_euroc(ep: dict) -> None:
    """Phase 12's lines."""
    ig = ep["ingest"]
    print(f"euroc 12a: tree of {ig['n']} frames (480x752 cam0, cam1, depth0, 200 Hz IMU, "
          f"ground truth) written in {ep['tree_s']:.1f} s; {_print_ingest(ig)}", flush=True)
    for mode, *_ in EUROC_ARMS:
        _print_arm(f"12b {mode}", ep[mode])
        if mode == "mono":
            _print_arm("12b mono on the host decoder", ep["mono_host"])
            nat, host = (ep[k]["kinds"].get("tracked frame", {}).get("median_ms")
                         for k in ("mono", "mono_host"))
            ratio = "n/a" if not (nat and host) else f"{nat / host:.3f}"
            print(f"euroc 12b mono, native ingest against the host decoder: tracked frames' "
                  f"median {nat} ms against {host} ms (ratio {ratio}); waits for the image "
                  f"{ep['mono']['ingest_ms']} ms against {ep['mono_host']['ingest_ms']} ms",
                  flush=True)
    tv = ep["tumvi_stereo_inertial"]
    print(f"euroc 12c: TUM-VI tree of {tv['ingest_cam0']['n']} frames (512x512 raw KB8 cam0, "
          f"cam1, 200 Hz body-frame IMU, ground truth) written in {tv['tree_s']:.1f} s; "
          f"rectified cam0: {_print_ingest(tv['ingest_cam0'])}; rectified cam1: "
          f"{_print_ingest(tv['ingest_cam1'])}", flush=True)
    _print_arm(f"12c tumvi stereo-inertial --clahe {TUMVI_CLAHE}", tv)


TOOLS_PLACES, TOOLS_SIZES = 16, (8, 16)


def tools_phase(dev) -> dict:
    """Phase 13 on device `dev`: the extraction bench, the vocabulary trainer
    and the recall curve through their `main`s, each with the launch counters
    set to 0 just before it and read just after; the trainer's k-means and
    the recall rows again on the CPU from the descriptors the card made.
    Raises on a failed check; returns the numbers."""
    import io
    import shutil
    from unittest import mock
    import numpy as np
    from orbslam3_tpu_torch.ops import orb_patches
    from orbslam3_tpu_torch.tools import train_vocab, vocab_recall_curve
    from orbslam3_tpu_torch.tools.drives import drive_extract_bench

    cuda = [] if dev.type == "cuda" else ["--device", str(dev)]
    out: dict = {}

    def run(name, fn, want):
        buf = io.StringIO()
        t0 = time.perf_counter()
        orb_patches.reset_counters()
        with contextlib.redirect_stdout(buf):
            res = fn()
        launches = orb_patches.launch_counts()
        out[name] = dict(launches=launches, s=time.perf_counter() - t0)
        if launches != orb_patches.path_counts(want):
            _fail(f"tools {name}: launch counters {launches}, {want} extractions")
        return res

    # 13a: the extraction bench
    iters = 30
    b = run("extract_bench", lambda: drive_extract_bench.main([str(iters)] + cuda),
            1 + iters + drive_extract_bench.N_PROFILED)
    if dev.type == "cuda" and not (b["device_ms"] and b["device_ms"] > 0):
        _fail(f"tools 13a: no device time ({b})")
    out["extract_bench"]["res"] = b

    # 13b: the vocabulary trainer, cut to 4 views and 256 words
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orbslam3_tpu_torch",
                        "build", f"tools_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        descs = os.path.join(root, "descs.npz")
        views, words = 4, 256
        run("train_vocab", lambda: train_vocab.main(
            ["--stage", "extract", "--n-views", str(views), "--desc-file", descs] + cuda), views)
        km = ["--stage", "kmeans", "--n-words", str(words), "--desc-file", descs]
        cb = {}
        for name, d in (("card", cuda), ("cpu", ["--device", "cpu"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cb[name] = train_vocab.main(km + ["--out", os.path.join(root, f"{name}.npy")] + d)
            out["train_vocab"][f"kmeans_{name}_s"] = time.perf_counter() - t0
            out["train_vocab"][f"entropy_{name}"] = buf.getvalue().splitlines()[-1].split("; ")[1]
        if not np.array_equal(cb["card"], cb["cpu"]):
            _fail(f"tools 13b: the card's codebook differs from the CPU's in "
                  f"{int((cb['card'] != cb['cpu']).any(1).sum())} of {words} words")
        out["train_vocab"]["n_desc"] = int(np.load(descs)["valid"].sum())
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 13c: the recall curve at 16 places, its rows again on the CPU
    env = {"RECALL_PLACES": str(TOOLS_PLACES), "RECALL_SIZES": ",".join(map(str, TOOLS_SIZES)),
           "RECALL_VOCABS": "4096"}
    keep: dict = {}
    with mock.patch.dict(os.environ, env):
        rows = run("recall_curve", lambda: vocab_recall_curve.main(cuda, keep=keep),
                   2 * TOOLS_PLACES)
    cpu_rows = vocab_recall_curve.recall_rows(keep, (4096,), TOOLS_SIZES, "cpu", echo=False)
    margin = max(abs(a[4] - b_[4]) for a, b_ in zip(rows, cpu_rows))
    if [r[:4] for r in rows] != [r[:4] for r in cpu_rows] or margin > 1e-5:
        _fail(f"tools 13c: card rows {rows} against the CPU's {cpu_rows}")
    out["recall_curve"].update(rows=rows, margin_diff=margin)
    return out


def print_tools(tp: dict) -> None:
    """Phase 13's lines."""
    b = tp["extract_bench"]
    r = b["res"]
    dev_part = "device time: not measured" if r["device_ms"] is None else (
        f"device {r['device_ms']:.3f} ms per extract ({r['kernels_per_extract']:.1f} kernels), "
        f"orb_describe {r['orb_describe_ms'] * 1e3:.2f} us = "
        f"{100 * r['orb_describe_share']:.2f}% of it; top kernels "
        + ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in r["top"]))
    print(f"tools 13a extract bench: {r['iters']} frames, dependent chain "
          f"{r['ms_per_frame']:.3f} ms per frame ({r['fps']:.1f} fps) on the host clock; "
          f"{dev_part}; {b['s']:.1f} s; launches {b['launches']}", flush=True)
    t = tp["train_vocab"]
    print(f"tools 13b train_vocab: 4 views, {t['n_desc']} descriptors, 256 words; codebook on "
          f"the card equal to the CPU's (k-means {t['kmeans_card_s']:.2f} s on the card, "
          f"{t['kmeans_cpu_s']:.2f} s on the CPU); {t['entropy_card']}; extraction "
          f"{t['s']:.1f} s; launches {t['launches']}", flush=True)
    c = tp["recall_curve"]
    rows = "; ".join(f"V {v} M {m}: r@1 {r1:.3f} r@3 {r3:.3f} margin {mg:+.4f}"
                     for v, m, r1, r3, mg in c["rows"])
    print(f"tools 13c recall curve: {TOOLS_PLACES} places; {rows}; the CPU's rows from the "
          f"card's descriptors equal (margins within {c['margin_diff']:.2g}); {c['s']:.1f} s; "
          f"launches {c['launches']}", flush=True)


def distribution_phase(dev) -> dict:
    """Phase 14: the sharded BA (a), the engine's sharded local BA (b),
    across processes and the dry run (c); each part with the launch
    counters set to 0 just before it and read just after.  Raises on a
    failed gate; returns the phase's numbers."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from orbslam3_tpu_torch import graft_entry
    from orbslam3_tpu_torch.ops import orb_patches
    from orbslam3_tpu_torch.parallel import dist_ba, multihost
    from orbslam3_tpu_torch.pipeline import system
    from orbslam3_tpu_torch.tools import bench_multihost
    from orbslam3_tpu_torch.utils import dist_scene, engine_mesh, sync_census

    out = {}
    bad = []
    iters, pcg = 4, 32
    modes = ("matvec", "dense", "camshard")
    # the collectives per LM iteration that JAX's docstring counts, and the
    # port's own count of the same scheme
    jax_count = {"matvec": 3 + pcg, "dense": 2, "camshard": None}
    port_count = {"matvec": pcg + 6, "dense": 2, "camshard": 4 + 4 * pcg}

    # (a) the solver at bench_multihost's per-shard width on 8 local shards
    orb_patches.reset_counters()
    prob_c, (_, t_gt, X_gt) = dist_scene.problem()
    cam = torch.tensor(dist_scene.K4, device=dev)
    dprob = dist_ba.partition_problem(dist_scene.problem(device=dev)[0], 8)
    dprob_c = dist_ba.partition_problem(prob_c, 8)

    def solve(comm, mesh, p=dprob, c=cam):
        return dist_ba.dist_bundle_adjust(p, mesh, cam_params=c, iterations=iters,
                                          pcg_iters=pcg, comm=comm)

    res = {}
    for comm in modes:
        mesh = multihost.Mesh(8)
        solve(comm, mesh)                                  # warm-up
        torch.cuda.synchronize()
        mesh.n_collectives = 0
        found = []
        with sync_census._sync_warnings(found):
            (R, t, X, cost), ms = _timed_events(lambda: solve(comm, mesh))
        coll = (mesh.n_collectives - 1) / iters            # the points' gather is outside
        Rc, tc, Xc, cc = solve(comm, multihost.Mesh(8), dprob_c, cam.cpu())
        t_err = float((t.cpu() - t_gt).norm(dim=1).max())
        x_err = float((X.cpu() - X_gt).norm(dim=1).mean())
        cpu = max(float((t.cpu() - tc).abs().max()), float((R.cpu() - Rc).abs().max()),
                  float((X.cpu() - Xc).abs().max()))
        again = solve(comm, multihost.Mesh(8))
        same = all(torch.equal(a, b) for a, b in zip((R, t, X, cost), again))
        res[comm] = (R, t, X, cost)
        out[comm] = dict(ms_per_iter=ms / iters, t_err=t_err, x_err=x_err, cpu=cpu, cost=float(cost),
                         collectives=coll, reads=len(found), sites=collections.Counter(found),
                         repeat_equal=same)
        if not (t_err < 5e-3 and x_err < 5e-3):
            bad.append(f"{comm}: translations {t_err}, points {x_err} from the truth")
        if not cpu < 1e-4:
            bad.append(f"{comm}: the card {cpu} from the CPU")
        if coll != port_count[comm]:
            bad.append(f"{comm}: {coll} collectives per LM iteration, not {port_count[comm]}")
        if not same:
            bad.append(f"{comm}: a second solve differs from the first")
    for comm in ("dense", "camshard"):
        d = float((res[comm][1] - res["matvec"][1]).abs().max())
        out[comm]["vs_matvec"] = d
        if not d < 2e-3:
            bad.append(f"{comm}: {d} from matvec's translations")
    # the same solves under a process group of NCCL at world size 1, NCCL's
    # only form on one card: they must equal the runs without a group
    rdv = tempfile.mkdtemp(prefix="slam_pg_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="file://" + os.path.join(rdv, "store"),
                            world_size=1, rank=0)
    try:
        for comm in modes:
            mesh = multihost.global_mesh(local=8)
            got = solve(comm, mesh)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, res[comm]))
            out[comm]["nccl_equal"] = same
            if mesh.world != 1 or mesh.group is None or not same:
                bad.append(f"{comm} under NCCL at world size 1: equal {same}")
        out["nccl_backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    launches = {"dist_ba": orb_patches.launch_counts()}

    # (b) the engine: test_engine_mesh's scene sharded and on one device
    orb_patches.reset_counters()
    t0 = time.perf_counter()
    local = []
    with engine_mesh.local_ba_as(_events(local, system.local_ba)):
        sharded = engine_mesh.run(engine_mesh.config(ba_mesh_shards=8), dev)
    one = engine_mesh.run(engine_mesh.config(), dev, coo=True)
    launches["engine_mesh"] = orb_patches.launch_counts()
    bad += [f"engine: {b}" for b in engine_mesh.gates(one, sharded)]
    s8 = sharded[0]
    for name, tensor in (("map", s8.map.pt_xyz), ("bank", s8.bank.xy)):
        if tensor.device.type != "cuda":
            bad.append(f"engine: the {name} is on {tensor.device}")
    # the sharded window BA beside the grid and the one-device COO ones, on
    # the sharded run's last map
    m, bank, ki, cam8 = s8.map, s8.bank, s8.last_kf_idx, s8.cam_params
    grid_cfg = engine_mesh.config()
    ba_ms = {"sharded": _event_ms(lambda: system.local_ba(s8.cfg, cam8, m, ki, bank), runs=5),
             "grid": _event_ms(lambda: system.local_ba(grid_cfg, cam8, m, ki, bank), runs=5),
             "coo": _event_ms(lambda: engine_mesh.coo_local_ba(grid_cfg, cam8, m, ki, bank),
                              runs=5)}
    out["engine"] = dict(ate_sharded=sharded[1], ate_one=one[1],
                         apart=engine_mesh.apart(one, sharded), n_kf=s8.n_kf_host,
                         n_pt=int(s8.map.pt_valid.sum()), resets=(one[0].n_resets, s8.n_resets),
                         n_local_ba=len(local), local_ms=statistics.median(_ms(local)),
                         ba_ms=ba_ms, s=time.perf_counter() - t0)

    # (c) across processes (gloo between two processes, the shards on this
    # card) against one process of 4 shards; the dry run at 1-8 shards
    orb_patches.reset_counters()
    t0 = time.perf_counter()
    where = ["--device", dev.type, "--comm", "dense"]
    two = bench_multihost.main(["--procs", "2", "--dev-per-proc", "2"] + where)
    four = bench_multihost.main(["--local-devices", "--dev-per-proc", "4"] + where)
    a, b = two["detail"][2], four["detail"][4]
    dt = float(np.abs(np.asarray(a["t"]) - np.asarray(b["t"])).max())
    dc = abs(a["cost"] - b["cost"]) / max(b["cost"], 1.0)
    if not (a["n_shards"] == b["n_shards"] == 4 and dt < 5e-2 and dc < 0.2):
        bad.append(f"2 x 2 processes against 1 x 4: translations {dt}, cost {dc} relative")
    if a["backend"] != "gloo" or not a["device"].startswith(dev.type):
        bad.append(f"2 x 2: backend {a['backend']} on {a['device']}")
    for n in (1, 2, 4, 8):
        graft_entry.dryrun_multichip(n, dev)
    launches["multiprocess"] = orb_patches.launch_counts()
    out["multiprocess"] = dict(two=two, four=four, dt=dt, dc=dc, s=time.perf_counter() - t0)
    for k, v in launches.items():
        if v != orb_patches.path_counts(0):
            bad.append(f"launches of {k}: {v}, none expected (no frame is extracted)")
    out["launches"] = launches
    if bad:
        _fail("distribution: " + "; ".join(bad))
    out["jax_count"], out["port_count"] = jax_count, port_count
    return out


def _timed_events(fn):
    """(fn(), CUDA-event ms around it)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    r = fn()
    end.record()
    torch.cuda.synchronize()
    return r, start.elapsed_time(end)


def print_distribution(dp: dict) -> None:
    for comm in ("matvec", "dense", "camshard"):
        d = dp[comm]
        vs = f", {d['vs_matvec']:.3g} from matvec's translations" if "vs_matvec" in d else ""
        print(f"distribution {comm}: 8 shards on the card, 32 cameras / 16384 points / 65536 "
              f"observations, 4 LM steps: {d['ms_per_iter']:.3f} ms per LM iteration (CUDA "
              f"events); translations {d['t_err']:.3g} and points {d['x_err']:.3g} from the "
              f"truth{vs}; the CPU's solve {d['cpu']:.3g} away; a second solve bit-equal "
              f"{d['repeat_equal']}, under NCCL at world size 1 bit-equal {d['nccl_equal']}; "
              f"{d['collectives']:g} collectives per LM iteration (JAX's docstring: "
              f"{dp['jax_count'][comm]}); {d['reads']} blocking reads per solve "
              f"{dict(d['sites'])}", flush=True)
    e = dp["engine"]
    print(f"distribution engine: ATE sharded {e['ate_sharded']:.5g}, one device (COO) "
          f"{e['ate_one']:.5g}, {e['apart']:.5g} apart; {e['n_kf']} keyframes, {e['n_pt']} "
          f"points, resets {e['resets']}; {e['n_local_ba']} sharded window BAs, median "
          f"{e['local_ms']:.1f} ms (events); on the last map: sharded "
          f"{e['ba_ms']['sharded']:.1f} ms, grid {e['ba_ms']['grid']:.1f} ms, one-device COO "
          f"{e['ba_ms']['coo']:.1f} ms; {e['s']:.1f} s", flush=True)
    mp = dp["multiprocess"]
    for name, line in (("2 processes x 2 shards (gloo)", mp["two"]),
                       ("1 process, 1 against 4 shards", mp["four"])):
        shown = {k: v for k, v in line.items() if k != "detail"}
        per = {n: {k: d[k] for k in ("n_processes", "n_shards", "ms_per_lm_iter", "backend",
                                     "collectives_per_lm_iter", "cost")}
               for n, d in line["detail"].items()}
        print(f"distribution {name}: {json.dumps(shown)} {json.dumps(per)}", flush=True)
    print(f"distribution across processes: 2 x 2 against 1 x 4 translations {mp['dt']:.3g}, "
          f"cost {mp['dc']:.3g} relative; dryrun_multichip at 1, 2, 4, 8 shards finite; "
          f"{mp['s']:.1f} s", flush=True)


# phase 15: the inertial chain's frames after its warm-up (bench.py's 48, 12
# of them settling), cut to 24 for the smoke's time limit (with 48, and 11c
# at 40, the smoke took 1,218 s on an H100 whose host ran every phase
# 1.2-1.4x slower than usual; on the CPU the chain's gates hold at 24, 2
# keyframes and an ATE of 0.031 of the span; `python -m
# orbslam3_tpu_torch.bench` runs it uncut)
BENCH_INERTIAL_MEASURE = 24


def bench_phase(dev) -> dict:
    """Phase 15: bench.py's three chains through `orbslam3_tpu_torch.bench`
    on device `dev`, each with the launch counters set to 0 just before it
    and read just after (`orb_describe` once per extraction: the chain's,
    its warm-up's and its census pass's), under the chains' own asserts and
    the phase's gates; then the full chain's first timed frame and
    keyframe step again on the CPU.  Raises on a failed check; returns the
    numbers."""
    from orbslam3_tpu_torch import bench
    from orbslam3_tpu_torch.ops import orb_patches

    out: dict = {}

    def run(name, fn, n_extract):
        orb_patches.reset_counters()
        t0 = time.perf_counter()
        res = fn()
        launches = orb_patches.launch_counts()
        out[name] = dict(res=res, launches=launches, s=time.perf_counter() - t0)
        want = n_extract(res)
        if launches != orb_patches.path_counts(want):
            _fail(f"bench {name}: launch counters {launches}, {want} extractions")
        return res

    def ate_gate(name, res):
        rmse, scale, span = res.info["ate"]
        if not rmse < 0.08 * span:
            _fail(f"bench {name}: ATE {rmse:.4g} of a span of {span:.4g}")

    # the tracking chain: the map's image, a warm call, the chain, the census
    tr = run("tracking", lambda: bench.bench_tracking_chain(dev),
             lambda r: 2 + bench.TRACK_ITERS + bench.SETTLE)
    bad = bench.tracking_faults(tr)
    if bad:
        _fail("bench tracking: " + "; ".join(bad))
    # the full chain: 30 warm-up frames, 48 chain frames, the census over 12
    full = run("full", lambda: bench.bench_full_system(dev),
               lambda r: bench.FULL_WARMUP + bench.MEASURE + bench.SETTLE)
    min_inl = bench.slam_config().min_track_inliers
    weak = [(i, n) for i, *_, n in full.frames if i >= full.info["timed_from"] and n < min_inl]
    if weak:
        _fail(f"bench full: timed frames below {min_inl} inliers: {weak}")
    if full.keyframes < 1:
        _fail("bench full: no keyframe inserted")
    ate_gate("full", full)
    t0 = time.perf_counter()
    bad, out["recheck"] = bench.recheck_on_cpu(full)
    out["recheck"]["s"] = time.perf_counter() - t0
    if bad:
        _fail("bench full, card against the CPU: " + "; ".join(bad))
    # the inertial chain: its warm-up, the chain, the census over 12
    vi = run("inertial", lambda: bench.bench_full_inertial(dev, measure=BENCH_INERTIAL_MEASURE),
             lambda r: r.info["warmup_frames"] + BENCH_INERTIAL_MEASURE + bench.SETTLE)
    if vi.keyframes < 1:
        _fail("bench inertial: no keyframe inserted")
    ate_gate("inertial", vi)
    return out


def print_bench(bp: dict) -> None:
    """Phase 15's lines."""
    import numpy as np
    from orbslam3_tpu_torch import bench
    for name in ("tracking", "full", "inertial"):
        b = bp[name]
        r = b["res"]
        extra = ""
        if name == "tracking":
            n_nan = sum(not np.isfinite(R).all() for _, R, _, _ in r.frames)
            extra = (f"; the first frame {r.frames[0][3]} inliers; {n_nan} NaN poses (a frame "
                     f"with no inlier gives one on the CPU, in JAX as in the port)")
        else:
            rmse, scale, span = r.info["ate"]
            inl = [n for i, *_, n in r.frames if i >= r.info["timed_from"]]
            extra = (f"; initialized at frame {r.info['init_frame']}; {r.info['points']} valid "
                     f"points; timed inliers {min(inl)}-{max(inl)}; "
                     f"ATE {rmse:.5g} after alignment with scale {scale:.5g}, "
                     f"{rmse / span:.4f} of the span {span:.4g}")
        if name == "inertial":
            extra += (f"; warm-up {r.info['warmup_frames']} frames, the IMU initialized at "
                      f"frame {r.info['imu_init_frame']}")
        reads = ("not measured" if r.reads is None else
                 ", ".join(f"{k} {v:.2f}" for k, v in r.reads.items()))
        measure = BENCH_INERTIAL_MEASURE if name == "inertial" else bench.MEASURE
        over = f"{bench.TRACK_ITERS} frames" if name == "tracking" else \
            f"{measure - bench.SETTLE} of {measure} frames"
        print(f"bench {name}: {r.fps:.3f} fps ({r.ms_per_frame:.2f} ms per frame) over {over}, "
              f"{r.keyframes} keyframes; blocking reads per frame: {reads}{extra}; "
              f"{b['s']:.1f} s; launches {b['launches']}", flush=True)
    c = bp["recheck"]
    print(f"bench full against the CPU: frame {c['frame']} pose |diff| "
          f"{c['track_pose']:.3g}, inliers {c['track_inliers'][0]} (CPU "
          f"{c['track_inliers'][1]}); keyframe step at frame {c['kf_frame']}: {c['n_new']} new "
          f"points, {c['kf']['relabelled']} in swapped slots, max pose |diff| "
          f"{c['kf']['pose']:.3g}, max point relative diff {c['kf']['point']:.3g}; "
          f"{c['s']:.1f} s", flush=True)


# phase 16: the inertial scenarios F, G and J run to their IMU initialization
# and this many frames more (uncut, 120, 100 and 70 frames, they run outside
# the smoke; each cut holds every gate of its scenario on the CPU:
# `tests/acceptance_numbers.py cut 0 0 6 6 12`)
ACCEPT_AFTER_IMU = {"F": 12, "G": 6, "J": 6}
# phase 16: B's frames whose atlases hold orb_describe against describe_plain
# (the darkest and blurred first frame, a middle one, the brightest last)
STRESSED_FRAMES = (0, 17, 35)
# phase 16: J's rectified images whose atlases do the same (the first pair's
# left and right, the last frame's left)
RECTIFIED_IMAGES = ((0, 0), (0, 1), (69, 0))


def atlas_check(images, p, dev) -> dict:
    """`orb_describe` against `describe_plain` on the card on the atlases of
    `images` (extracted with `OrbParams` `p`): descriptors bit-identical to
    the plain version's at the kernel's own angles, moments bit-equal to
    `ic_moments`'; angle bins and descriptor bits off against the plain
    version's angles counted.  Raises on a failed check."""
    import torch
    from orbslam3_tpu_torch.features import extractor
    from orbslam3_tpu_torch.ops import brief, orb_patches
    out = {"keypoints": 0, "bins_off": 0, "bits_off_plain_angles": 0, "max_angle": 0.0}
    for i, img in enumerate(images):
        sel = extractor.select_keypoints(torch.from_numpy(img).to(dev), p)
        atlas, blur, xy = sel.atlas, sel.atlas_blur, sel.xy_atlas
        ang, desc, mom = orb_patches.orb_describe(atlas, blur, xy, with_moments=True)
        ang_p, desc_p = orb_patches.describe_plain(atlas, blur, xy)
        if not torch.equal(mom, orb_patches.ic_moments(atlas, xy)):
            _fail(f"orb_describe on atlas {i}: moments differ from ic_moments'")
        own = int(brief.unpack_bits(desc ^ brief.compute_descriptors(blur, xy, ang)).sum())
        if own:
            _fail(f"orb_describe on atlas {i}: {own} descriptor bits off the plain "
                  f"version's at the kernel's angles")
        d = (ang - ang_p).abs()
        d = torch.minimum(d, 360.0 - d)
        out["keypoints"] += int(xy.shape[0])
        out["bins_off"] += int((brief.angle_bins(ang) != brief.angle_bins(ang_p)).sum())
        out["bits_off_plain_angles"] += int(brief.unpack_bits(desc ^ desc_p).sum())
        out["max_angle"] = max(out["max_angle"], float(d.max()))
        out.setdefault("atlas", tuple(atlas.shape))
    return out


def stressed_atlas_check(dev) -> dict:
    """`atlas_check` on B's stressed atlases (240x376, 4 levels; drifting
    exposure and gamma, vignetting, blur, noise 4), frames
    `STRESSED_FRAMES`."""
    from orbslam3_tpu_torch.utils import acceptance as acc
    images, _ = acc.sweep_images(True)
    return atlas_check([images[i] for i in STRESSED_FRAMES], acc.orb_params(), dev)


def rectified_atlas_check(dev) -> dict:
    """`atlas_check` on J's rectified fisheye images (384x384, 8 levels,
    800 features), `RECTIFIED_IMAGES` (frame, side)."""
    from orbslam3_tpu_torch.utils import acceptance as acc
    frames = sorted({f for f, _ in RECTIFIED_IMAGES})
    pairs = dict(zip(frames, acc.j_pairs(frames)))
    return atlas_check([pairs[f][side] for f, side in RECTIFIED_IMAGES],
                       acc.j_configs()[0].orb, dev)


def acceptance_phase(dev) -> dict:
    """Phase 16: the JAX suite's acceptance scenarios A-J through
    `utils/acceptance.py` on device `dev`, each with the launch counters set
    to 0 just before it and read just after (`orb_describe` once per image
    extracted: A, B 36, C 2, D, E 5, F-I 0, J 2 per frame), F, G and J cut
    by `ACCEPT_AFTER_IMU`, under the JAX test's gates and the card's check
    against the CPU; each scenario's line printed as it ends.  Then
    `stressed_atlas_check` and `rectified_atlas_check`.  Raises after the
    last scenario if any gate failed; returns the results."""
    from orbslam3_tpu_torch.ops import orb_patches
    from orbslam3_tpu_torch.utils import acceptance as acc
    out, bad = {}, []
    for name, run in acc.SCENARIOS.items():
        kw = {"after_imu": ACCEPT_AFTER_IMU[name]} if name in ACCEPT_AFTER_IMU else {}
        orb_patches.reset_counters()
        r = run(dev, **kw)
        r["launches"] = orb_patches.launch_counts()
        if r["launches"] != orb_patches.path_counts(r["extracts"]):
            r["bad"].append(f"launch counters {r['launches']} for {r['extracts']} extractions")
        out[name] = r
        print_accept(r)
        bad += [f"accept {name}: {b}" for b in r["bad"]]
    for key, check in (("stressed", stressed_atlas_check), ("rectified", rectified_atlas_check)):
        t0 = time.perf_counter()
        out[key] = check(dev)
        out[key]["s"] = time.perf_counter() - t0
    if bad:
        _fail("; ".join(bad))
    return out


def print_accept(r: dict) -> None:
    """One scenario's line of phase 16."""
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.5g}"
        if isinstance(v, list):
            return "[" + ", ".join(fmt(x) for x in v) + "]"
        if isinstance(v, dict):
            return "(" + ", ".join(f"{k} {fmt(x)}" for k, x in v.items()) + ")"
        return str(v)
    gates = ", ".join(f"{k} {fmt(v)}" for k, v in r["gates"].items())
    kinds = "; ".join(f"{k} {ms:.1f} ms x {n}" for k, (ms, n) in r["kinds"].items())
    drive = ""
    if "frames" in r:
        drive = (f"; frames {r['frames']}, OK {r['ok']}, keyframes {r['keyframes']}, "
                 f"initialized at frame {r['init_frame']}")
    if "imu_frame" in r:
        drive += f", the IMU at frame {r['imu_frame']}, VIBA1 {r['viba1']}"
    if r.get("last_closure") is not None:
        drive += f", last closure {r['last_closure']}"
    check = r.get("card_check") or {}
    check = ", ".join(f"{k} {fmt(v)}" for k, v in check.items())
    print(f"accept {r['name']}: {'PASS' if not r['bad'] else 'FAIL ' + '; '.join(r['bad'])}; "
          f"gates: {gates}{drive}; host ms per frame kind: {kinds}; card against the CPU: "
          f"{check}; {r['seconds']:.1f} s; launches {r['launches']}", flush=True)


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

    # the one-launch kernels against the composition of the plain versions:
    # the Hopper design (`orb_describe`, the one every path runs) and the
    # earlier one-warp-per-keypoint design (`orb_describe_warp`), each held
    # to the same gates
    ang_p, _ = orb_patches.describe_plain(atlas, blur, xy)
    ang_tol = torch.rad2deg(1e-5 * torch.linalg.norm(mass, dim=1)
                            / torch.linalg.norm(mom_t, dim=1)) + 1e-4

    def hold(name, describe):
        ang_f, desc_f, mom_f = describe(atlas, blur, xy, with_moments=True)
        torch.cuda.synchronize()
        if not torch.equal(mom_f, mom_k):
            _fail(f"{name}: moments differ from ic_moments'")
        if not torch.equal(ang_f[lv0], ang_p[lv0]):
            _fail(f"{name}: level-0 angles differ from the plain version's")
        d_ang = (ang_f - ang_p).abs()
        d_ang = torch.minimum(d_ang, 360.0 - d_ang)
        if bool((d_ang > ang_tol).any()):
            _fail(f"{name}: angle off by {d_ang.max().item()} deg")
        bins_off = brief.angle_bins(ang_f) != brief.angle_bins(ang_p)
        if int(bins_off[lv0].sum()):
            _fail(f"{name}: {int(bins_off[lv0].sum())} level-0 keypoints in another angle bin")
        bits = int(brief.unpack_bits(
            desc_f ^ brief.compute_descriptors(blur, xy, ang_f)).sum(dim=1).max().item())
        if bits != 0:
            _fail(f"{name}: descriptors differ from the plain version ({bits} bits)")
        return ang_f, desc_f, d_ang, int(bins_off.sum()), bits

    ang_f, desc_f, d_ang, bins_off, fused_bits = hold("orb_describe", orb_patches.orb_describe)
    ang_w, desc_w, d_ang_w, bins_off_w, warp_bits = hold("orb_describe_warp",
                                                         orb_patches.orb_describe_warp)
    if not (torch.equal(ang_w, ang_f) and torch.equal(desc_w, desc_f)):
        _fail("orb_describe and orb_describe_warp give different angles or descriptors")

    calls = {"ic_moments": lambda: orb_patches.ic_moments(atlas, xy),
             "brief_desc": lambda: orb_patches.brief_descriptors(blur, xy, angle),
             "orb_describe_warp": lambda: orb_patches.orb_describe_warp(atlas, blur, xy),
             "orb_describe": lambda: orb_patches.orb_describe(atlas, blur, xy)}
    plains = {"ic_moments": lambda: orient.ic_moments(atlas, xy),
              "brief_desc": lambda: brief.compute_descriptors(blur, xy, angle),
              "orb_describe": lambda: orb_patches.describe_plain(atlas, blur, xy)}
    plain_ms = {k: _event_ms(f) for k, f in plains.items()}
    plain_ms["orb_describe_warp"] = plain_ms["orb_describe"]    # the same function
    work = patch_kernel_work(sel, ang_f)
    work["orb_describe_warp"] = work["orb_describe"]

    # CUDA events around one launch through the wrapper (median of 50) and
    # the device durations of the kernels themselves (torch.profiler, 50
    # records), each kernel through its wrapper; the two one-launch designs
    # in turns (warp, Hopper, Hopper, warp), and a kernel that does nothing
    # as the floor of a launch's device duration
    def device_us(fn, name):
        durs, _ = profile_keyframe.kernel_durations(fn, [name])
        return durs[name]

    ev_ms, dev_recs = {}, {}
    for k in ("ic_moments", "brief_desc", "orb_describe_warp", "orb_describe",
              "orb_describe", "orb_describe_warp"):
        ev_ms.setdefault(k, []).append(_event_ms(calls[k]))
        dev_recs.setdefault(k, []).extend(device_us(calls[k], k + "_kernel"))
    turns = {k: [round(t * 1e3, 3) for t in ev_ms[k]]
             for k in ("orb_describe_warp", "orb_describe")}
    ev_ms = {k: statistics.median(v) for k, v in ev_ms.items()}
    dev_ms = {k: statistics.median(v) / 1e3 if v else None for k, v in dev_recs.items()}
    floor_recs = device_us(lambda: orb_patches.empty_kernel(dev), "orb_empty_kernel")
    floor_ms = statistics.median(floor_recs) / 1e3 if floor_recs else None
    floor_ev_ms = _event_ms(lambda: orb_patches.empty_kernel(dev))
    # how many kernels one call of the extractor's last stage launches
    _, per_call = profile_keyframe.kernel_durations(
        lambda: orb_patches.ic_angle_and_descriptors(atlas, blur, xy), [])
    # max_abs_err: moments for K1, descriptor bits for K2, degrees for the
    # one-launch kernels (their descriptor bits stand under `desc_bits_off`)
    err = {"ic_moments": float(k1_err.max().item()), "brief_desc": float(diff_bits),
           "orb_describe_warp": float(d_ang_w.max().item()),
           "orb_describe": float(d_ang.max().item())}
    bits_off = {"ic_moments": None, "brief_desc": diff_bits,
                "orb_describe_warp": warp_bits, "orb_describe": fused_bits}
    geometry = orb_patches.launch_geometry(n, torch.cuda.get_device_properties(0)
                                           .multi_processor_count)
    print(f"kernels: {n} keypoints, atlas {tuple(atlas.shape)}; K1 level-0 bit-equal, max|diff| "
          f"{err['ic_moments']:.3g}; K2 bit-identical; orb_describe and orb_describe_warp: "
          f"moments bit-equal to K1's, level-0 angles bit-equal, max angle diff "
          f"{d_ang.max().item():.3g} deg, {bins_off} keypoints in another bin than the plain "
          f"version's (0 on level 0), descriptors bit-identical at their own angles, the two "
          f"equal to each other; orb_describe's grid {geometry[0]} blocks x {geometry[1]} "
          f"warps, {geometry[2]} bytes of shared memory; kernels per call of the last "
          f"extraction stage: {per_call}", flush=True)
    for k in calls:
        d = "not measured" if dev_ms[k] is None else f"{dev_ms[k] * 1e3:.3f} us"
        print(f"  {k}: device {d}, events {ev_ms[k] * 1e3:.2f} us, plain "
              f"{plain_ms[k] * 1e3:.2f} us, bound {work[k]['bound_ms'] * 1e3:.3f} us by "
              f"{work[k]['bound_by']} ({work[k]['bytes']} bytes, {work[k]['ops']} operations)",
              flush=True)
    fl = "not measured" if floor_ms is None else f"{floor_ms * 1e3:.3f} us"
    print(f"  floor: an empty kernel, device {fl}, events {floor_ev_ms * 1e3:.2f} us; in turns "
          f"(warp, Hopper, Hopper, warp) events us: orb_describe_warp "
          f"{turns['orb_describe_warp']}, orb_describe {turns['orb_describe']}", flush=True)

    # where a launch's host time goes: host clock per call, 2000 calls each,
    # nothing synchronised between them
    def host_us(fn, calls=2000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return t

    host = {"orb_describe": host_us(calls["orb_describe"]),
            "its checks": host_us(lambda: orb_patches._check_pair(atlas, blur, xy)),
            "its two outputs": host_us(lambda: orb_patches._outputs(n, dev, False)),
            "empty_kernel": host_us(lambda: orb_patches.empty_kernel(dev))}
    print("  host us per call: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()),
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
    if launches != orb_patches.path_counts(n_extract):
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
    if kf_launches != orb_patches.path_counts(mp["n_extract"]):
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
    if sys_launches != orb_patches.path_counts(len(scfg.track_frames)):
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
    if reloc_launches != orb_patches.path_counts(n_fed):
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

    # 9. loop closing and async mapping -------------------------------------
    orb_patches.reset_counters()
    t0 = time.perf_counter()
    lp = {**async_loop_phase(scfg, sframes, dev), **closure_phase(dev)}
    loop_launches = orb_patches.launch_counts()
    if loop_launches != orb_patches.path_counts(len(scfg.track_frames)):
        _fail(f"launch counters {loop_launches} for {len(scfg.track_frames)} frames")
    print_loop(lp, st)
    print(f"loop: phase {time.perf_counter() - t0:.1f} s; launches {loop_launches}", flush=True)

    # 10. the multi-session Atlas, GNSS georeferencing, the checkpoint --------
    orb_patches.reset_counters()
    t0 = time.perf_counter()
    ap = atlas_phase(scfg, sframes, dev)
    atlas_launches = orb_patches.launch_counts()
    n_atlas = 2 * len(scfg.track_frames) + ap["checkpoint"]["frames"] + 1
    if atlas_launches != orb_patches.path_counts(n_atlas):
        _fail(f"launch counters {atlas_launches} for {n_atlas} extract calls")
    print_atlas(ap)
    print(f"atlas: phase {time.perf_counter() - t0:.1f} s; launches {atlas_launches}",
          flush=True)

    # 11. the other sensors -------------------------------------------------
    t0 = time.perf_counter()
    sp = sensors_phase(scfg, sframes, dev)
    print_sensors(sp)
    print(f"sensors: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 12. the EuRoC / TUM-VI sequence runner ---------------------------------
    t0 = time.perf_counter()
    ep = euroc_phase(dev)
    print_euroc(ep)
    print(f"euroc: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the tools ---------------------------------------------------------
    t0 = time.perf_counter()
    tp = tools_phase(dev)
    print_tools(tp)
    print(f"tools: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 14. distribution ------------------------------------------------------
    t0 = time.perf_counter()
    dp = distribution_phase(dev)
    print_distribution(dp)
    print(f"distribution: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 15. bench.py's chains ---------------------------------------------------
    t0 = time.perf_counter()
    bp = bench_phase(dev)
    print_bench(bp)
    print(f"bench: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 16. the JAX suite's acceptance scenarios --------------------------------
    t0 = time.perf_counter()
    xp = acceptance_phase(dev)
    for key, what in (("stressed", f"B's frames {list(STRESSED_FRAMES)}"),
                      ("rectified", f"J's rectified images {list(RECTIFIED_IMAGES)} "
                                    f"(frame, side)")):
        st = xp[key]
        print(f"accept {key} atlases: orb_describe on {what} (atlas {st['atlas']}), "
              f"{st['keypoints']} keypoints: moments bit-equal to ic_moments', descriptors "
              f"bit-identical to the plain version's at the kernel's angles; against the "
              f"plain version's angles {st['bins_off']} keypoints in another bin, "
              f"{st['bits_off_plain_angles']} bits off, max angle diff "
              f"{st['max_angle']:.3g} deg; {st['s']:.1f} s", flush=True)
    print(f"accept: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # report ----------------------------------------------------------------
    src = "orbslam3_tpu_torch/csrc/orb_patches.cu"
    replaces = {"ic_moments": "orbslam3_tpu/ops/pallas_patches.py:58",
                "brief_desc": "orbslam3_tpu/ops/pallas_patches.py:76",
                "orb_describe_warp": "orbslam3_tpu/ops/pallas_patches.py:180",
                "orb_describe": "orbslam3_tpu/ops/pallas_patches.py:180"}
    # launches: of the system path's own run.  No path launches the two
    # single kernels or the warp design: `orb_describe` carries their work in
    # one launch, and phase 3 alone launches them, to hold them against their
    # plain versions and to time them beside it
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": sys_launches[k],
         "launches_per_path": {"tracking": launches[k], "keyframe": kf_launches[k],
                               "system": sys_launches[k],
                               "relocalization": reloc_launches[k], "inertial": il[k],
                               "loop": loop_launches[k], "merge_gnss": atlas_launches[k],
                               **{p: sp[p]["launches"][k] for p in
                                  ("stereo", "rgbd", "stereo_inertial", "kb8_mono")},
                               **{"euroc_" + m.replace("-", "_"): ep[m]["launches"][k]
                                  for m, *_ in EUROC_ARMS},
                               "euroc_tumvi_stereo_inertial":
                                   ep["tumvi_stereo_inertial"]["launches"][k],
                               **{p: tp[p]["launches"][k] for p in
                                  ("extract_bench", "train_vocab", "recall_curve")},
                               **{p: n[k] for p, n in dp["launches"].items()},
                               **{"bench_" + p: bp[p]["launches"][k] for p in
                                  ("tracking", "full", "inertial")},
                               **{"accept_" + p.lower(): xp[p]["launches"][k] for p in
                                  "ABCDEFGHIJ"}},
         "max_abs_err": err[k], "ms": ev_ms[k], "plain_ms": plain_ms[k],
         "bound_ms": work[k]["bound_ms"], "bound_by": work[k]["bound_by"],
         "library_ms": None, "device_ms": dev_ms[k], "bytes": work[k]["bytes"],
         "operations": work[k]["ops"], "desc_bits_off": bits_off[k],
         "floor_device_ms": floor_ms}
        for k in ("ic_moments", "brief_desc", "orb_describe_warp", "orb_describe")]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
