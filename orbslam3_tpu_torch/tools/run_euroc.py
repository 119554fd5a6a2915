"""Run SLAM on a EuRoC / TUM-VI sequence and report the ATE.

Usage:
  python -m orbslam3_tpu_torch.tools.run_euroc <sequence_dir>
         [--mode mono|mono-inertial|stereo|stereo-inertial|rgbd]
         [--dataset euroc|tumvi] [--out traj.txt] [--max-frames N]
         [--viz map.png] [--device cuda|cpu]

The port of `tools/run_euroc.py`.  The sequence dir is the standard ASL
layout (contains mav0/).  EuRoC images are radtan-undistorted by the native
C++ ingest (`io/native_ingest.py`; libpng or PIL decodes) when it builds,
else on the host (`load_image` + `apply_undistort`, which has no CLAHE:
`--clahe` is refused there); the tool prints which decoder ran (`ingest:
native (libpng)`, `ingest: native (pil)` or `ingest: host (...)`).  The System
runs on the first CUDA device unless `--device cpu` is given; there is no
fallback.  The trajectory is written in the TUM format and evaluated
against the ground truth with Horn + scale alignment (reference oracle
evaluate_ate_scale.py).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from . import add_device_arg, device_of


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.run_euroc")
    ap.add_argument("sequence")
    ap.add_argument("--mode", default="mono",
                    choices=["mono", "mono-inertial", "stereo",
                             "stereo-inertial", "rgbd"])
    ap.add_argument("--depth-scale", type=float, default=5000.0,
                    help="rgbd: raw 16-bit depth units per meter "
                         "(TUM-RGBD convention 5000)")
    ap.add_argument("--dataset", default="euroc",
                    choices=["euroc", "tumvi"],
                    help="calibration preset family (tumvi = 512x512 "
                         "KB8 fisheye rig)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--viz", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--features", type=int, default=1200)
    ap.add_argument("--clahe", type=float, default=0.0,
                    help="CLAHE clip limit (0 = off), applied in ingest")
    ap.add_argument("--timeshift", type=float, default=0.0,
                    help="cam->IMU time offset [s] (grabber parity)")
    add_device_arg(ap)
    return ap


def _timed(it):
    """Yield (item, seconds spent waiting for it) from an iterator."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        yield item, time.perf_counter() - t0


def main(argv=None, on_frame=None) -> dict:
    """Run the tool with `argv` (default: the command line).

    `on_frame(i, system, before, track_s, ingest_s)`, if given, is called
    after every frame with the System's (state, imu_initialized, n_kf_host)
    from before the frame, the seconds of its track call and the seconds
    spent waiting for its images.  Returns the run's record: the System,
    the frames, the wall time, the decoder and the ATE (None without ground
    truth)."""
    ap = _parser()
    args = ap.parse_args(argv)

    from .. import config as presets
    from ..eval import ate
    from ..features.extractor import OrbParams
    from ..io import euroc, native_ingest, pump
    from ..pipeline import inertial_system, stereo_system
    from ..pipeline import system as slam

    dev = device_of(ap, args.device)
    seq = euroc.EurocSequence(args.sequence)
    tumvi = args.dataset == "tumvi"
    cam = euroc.TUMVI_CAM0 if tumvi else euroc.EUROC_CAM0
    orb = OrbParams(n_features=args.features)

    # TUM-VI mono modes consume raw KB8 fisheye pixels (cam_model="kb8",
    # no remap); EuRoC mono modes undistort radtan to the pinhole model
    maps = [None] if tumvi else \
        [euroc.undistort_map(cam["params"], cam["distortion"],
                             cam["resolution"])]
    if args.mode == "mono":
        cfg = (presets.tumvi_mono if tumvi else presets.euroc_mono)(orb=orb)
        sys_ = slam.System(cfg, device=dev)
    elif args.mode == "mono-inertial":
        cfg, icfg = (presets.tumvi_mono_inertial if tumvi
                     else presets.euroc_mono_inertial)(orb=orb)
        sys_ = inertial_system.InertialSystem(cfg, icfg, device=dev)
    elif args.mode == "stereo-inertial":
        # KB8 fisheye pair (TUM-VI) or radtan pair (EuRoC) rectified to
        # a shared virtual pinhole, fixed-scale inertial init
        from ..pipeline import stereo_inertial_system
        mk = presets.tumvi_stereo_inertial if tumvi \
            else presets.euroc_stereo_inertial
        cfg, icfg, scfg, map0, map1 = mk(orb=orb)
        sys_ = stereo_inertial_system.StereoInertialSystem(cfg, icfg, scfg, device=dev)
        maps = [map0, map1]
        seq_r = euroc.EurocSequence(args.sequence, cam="cam1")
    elif args.mode == "rgbd":
        # aligned metric depth in mav0/depth0/data/<ts>.png (16-bit,
        # depth_scale units per meter); RGB undistorted like mono
        if tumvi:
            ap.error("--mode rgbd uses the EuRoC pinhole preset; "
                     "--dataset tumvi (raw KB8 fisheye) is not a valid "
                     "combination")
        from ..pipeline import rgbd_system
        cfg, scfg = presets.euroc_rgbd(orb=orb)
        sys_ = rgbd_system.RGBDSystem(cfg, scfg, device=dev)
        seq_d = euroc.EurocSequence(args.sequence, cam="depth0")
    else:
        # RAW cam0+cam1 through calibration-derived rectification maps
        cfg, scfg, map0, map1 = presets.euroc_stereo_rectified(orb=orb)
        sys_ = stereo_system.StereoSystem(cfg, scfg, device=dev)
        maps = [map0, map1]
        seq_r = euroc.EurocSequence(args.sequence, cam="cam1")

    n = len(seq.images) if not args.max_frames else \
        min(args.max_frames, len(seq.images))
    native = native_ingest.available()
    decoder = "native" if native else "host"
    if not native and args.clahe > 0:
        ap.error(f"--clahe {args.clahe}: the host decoder has no CLAHE, and the native "
                 f"ingest does not build here ({native_ingest.build_error()})")
    print(f"ingest: native ({native_ingest.decoder()})" if native else
          f"ingest: host ({native_ingest.build_error()})", flush=True)

    def make_stream(s, umap):
        """The native threaded ingest when its library builds, else the
        host path."""
        if native:
            return iter(native_ingest.NativeIngest(
                [r.path for r in s.images[:n]], cam["resolution"], umap,
                src_hw=cam["resolution"], clahe_clip=args.clahe))
        return (s.load_image(s.images[i]) if umap is None else
                euroc.apply_undistort(s.load_image(s.images[i]), umap)
                for i in range(n))

    t0 = time.time()

    def step(i, ingest_s, track, *imgs, ts):
        before = (sys_.state, getattr(sys_, "imu_initialized", False), sys_.n_kf_host)
        t = time.perf_counter()
        state, _ = track(*imgs, ts)
        if on_frame is not None:
            on_frame(i, sys_, before, time.perf_counter() - t, ingest_s)
        if i % 100 == 0:
            print(f"frame {i}/{n} state={state} kf={sys_.n_kf_host} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    if args.mode == "stereo":
        pairs = zip(make_stream(seq, maps[0]), make_stream(seq_r, maps[1]))
        for i, ((left, right), wait) in enumerate(_timed(pairs)):
            step(i, wait, sys_.track_stereo, left, right, ts=seq.images[i].ts)
    elif args.mode == "stereo-inertial":
        # left camera + IMU through the sync pump; right camera decoded
        # in lockstep (pair indices align in the ASL layout)
        seq_r.images = seq_r.images[:n]
        right = make_stream(seq_r, maps[1])
        seq.images = seq.images[:n]
        for fr, wait in _timed(pump.pump_euroc(seq, remap=maps[0],
                                               timeshift_cam_imu=args.timeshift,
                                               clahe_clip=args.clahe)):
            for (t_imu, gyro, acc) in fr.imu:
                sys_.grab_imu(t_imu, gyro, acc)
            t1 = time.perf_counter()
            img_r = next(right)
            step(fr.index, wait + time.perf_counter() - t1, sys_.track_stereo,
                 fr.image, img_r, ts=fr.ts)
    elif args.mode == "rgbd":
        from PIL import Image
        for i, (left, wait) in enumerate(_timed(make_stream(seq, maps[0]))):
            t1 = time.perf_counter()
            depth = np.asarray(Image.open(seq_d.images[i].path),
                               dtype=np.float32) / args.depth_scale
            step(i, wait + time.perf_counter() - t1, sys_.track_rgbd, left, depth,
                 ts=seq.images[i].ts)
    else:
        # image+IMU through the sensor sync pump (reference SyncWithImu
        # batching semantics, image_grabber.hpp:113-225)
        seq.images = seq.images[:n]
        for fr, wait in _timed(pump.pump_euroc(seq, remap=maps[0],
                                               timeshift_cam_imu=args.timeshift,
                                               clahe_clip=args.clahe)):
            if args.mode == "mono-inertial":
                for (t_imu, gyro, acc) in fr.imu:
                    sys_.grab_imu(t_imu, gyro, acc)
            step(fr.index, wait, sys_.track_monocular, fr.image, ts=fr.ts)
    wall = time.time() - t0
    print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} fps), "
          f"resets={sys_.n_resets}")

    if args.out:
        with open(args.out, "w") as f:
            f.write(sys_.trajectory_tum())
        print("trajectory ->", args.out)
    if args.viz:
        from .. import viz
        print("map plot ->", viz.plot_map(sys_, args.viz))

    r = None
    try:
        gt_ts, gt_xyz = seq.read_groundtruth()
        est_ts = np.asarray([p[0] for p in sys_.trajectory])
        est_xyz = np.stack([p[2] for p in sys_.trajectory])
        r = ate.evaluate_ate(est_ts, est_xyz, gt_ts, gt_xyz)
        print("ATE: rmse=%.4f m  median=%.4f m  scale=%.3f  pairs=%d" %
              (r["rmse"], r["median"], r["scale"], r["n_pairs"]))
    except FileNotFoundError:
        print("no ground truth found; skipping ATE")
    return dict(system=sys_, frames=n, wall=wall, decoder=decoder, ate=r)


if __name__ == "__main__":
    main()
