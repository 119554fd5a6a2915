"""The CPU numbers that PERF.md, ROADMAP.md and tests/test_torch_acceptance.py
quote beside the acceptance scenarios (`orbslam3_tpu_torch/utils/acceptance.py`).

    JAX_PLATFORMS=cpu python tests/acceptance_numbers.py jax A B C D E F G H I J
    python tests/acceptance_numbers.py port A B C D E F G H I J
    python tests/acceptance_numbers.py seeds 0 12        # B under System seeds 0..11
    python tests/acceptance_numbers.py cut 72 30         # smoke phases 8 and 11c, cut
    python tests/acceptance_numbers.py cut 0 0 6 6 12    # phase 16's J, G and F, cut
    JAX_PLATFORMS=cpu python tests/acceptance_numbers.py floats   # J's and TUM-VI's float gaps

`jax`: each JAX test's drive on the JAX package, on the inputs the JAX test
builds (the builders of tests/test_torch_acceptance.py, which are the JAX
tests' own code), printing the values its gates read.  `port`: the port's
`run_<letter>("cpu")`.  `seeds`: scenario B on the port with other seeds of
the System's RANSAC generator (its initialization frame and frames OK).
`cut`: chip_smoke.py's phase 8 and 11c drives at the given depths on the
CPU, with their gates (a depth of 0 skips the drive), then phase 16's J, G
and F cut that many frames after their IMU initializes, where given.
`floats`: the numbers behind the tolerances of J's and the TUM-VI arm's
tests (the predicted scale levels at J's first tracked frame, JAX's and the
port's first tracked frames from their own maps and from JAX's, the
rectification maps' extent, both runners on a short TUM-VI tree).  Not a
test module: pytest does not collect it.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _jax(letter: str) -> dict:
    import jax.numpy as jnp
    import test_torch_acceptance as T
    from orbslam3_tpu.features.extractor import extract_jit
    from orbslam3_tpu.ops import align
    from orbslam3_tpu.pipeline import inertial_system as jis
    from orbslam3_tpu.pipeline import system as jsystem
    from orbslam3_tpu.pipeline import stereo_inertial_system as jsis
    from orbslam3_tpu.pipeline import loop_closing as jlc
    from orbslam3_tpu.place import keyframe_db as jkdb
    import torch_parity_helpers as H
    from orbslam3_tpu_torch.utils import acceptance as acc
    from test_inertial_pipeline import FPS, camera_path_smooth
    from test_long_run import RingWorld
    from test_pipeline_e2e import SyntheticWorld, camera_path

    def ate(sys_, centre_of, **kw):
        est = np.stack([p[2] for p in sys_.trajectory])
        gt = np.stack([centre_of(p[0]) for p in sys_.trajectory])
        if kw.pop("half", False):
            est, gt = est[len(est) // 2:], gt[len(gt) // 2:]
        rmse, s, _, _ = align.ate_rmse(jnp.asarray(est), jnp.asarray(gt), **kw)
        return float(rmse), float(s), float(np.linalg.norm(gt.max(0) - gt.min(0)))

    def states(sys_, feed, n):
        out = []
        for i in range(n):
            feed(i)
            out.append(int(sys_.state))
        return out, (out.index(jsystem.OK) if jsystem.OK in out else -1)

    if letter in "AB":
        images, centres = T._jax_sweep(letter == "B", 36)
        sys_ = jsystem.System(H.jax_config(acc.frontend_config()))
        st, init = states(sys_, lambda i: sys_.track_monocular(
            None, ts=i / 10.0, features=extract_jit(jnp.asarray(images[i]), T.JP)), 36)
        rmse, s, span = ate(sys_, lambda ts: centres[int(round(ts * 10))], with_scale=True)
        return dict(n_ok=st.count(jsystem.OK), init=init, resets=sys_.n_resets, ate=rmse,
                    span=span, n_kf=int(sys_.map.n_kf))
    if letter == "C":
        img1, img2, *poses = acc.repeatability_images()
        return T.jax_repeatability(T._extraction_matches_jax(img1)[0],
                                   T._extraction_matches_jax(img2)[0], poses)
    if letter in "DE":
        ref = T._jax_places(letter == "E")
        lc = jlc.LoopCloser(jlc.LoopConfig(), 16)
        for k, img in enumerate(ref[:4]):
            ff = extract_jit(jnp.asarray(img), T.JP)
            lc.db = jkdb.add(lc.db, k, lc._bow(ff.desc, ff.valid)[0])
        ff = extract_jit(jnp.asarray(ref[4]), T.JP)
        s = np.asarray(jkdb.query(lc.db, lc._bow(ff.desc, ff.valid)[0])[0][:4])
        return dict(scores=s.tolist(), margin=float(s[2] / np.delete(s, 2).max()))
    if letter in "FG":
        n = 120 if letter == "F" else 100
        _, pos, *_ = camera_path_smooth(n)
        if letter == "F":
            frames, imu = T._jax_f_inputs(n)
            sys_ = jis.InertialSystem(*(H.jax_config(c) for c in acc.f_configs()))
        else:
            frames, imu = T._jax_g_inputs(n)
            sys_ = jsis.StereoInertialSystem(*(H.jax_config(c) for c in acc.g_configs()))
        imu_frame = []

        def feed(i):
            for sample in imu[i]:
                sys_.grab_imu(*sample)
            if letter == "F":
                sys_.track_monocular(None, ts=i / FPS, features=frames[i])
            else:
                sys_.track_stereo(None, None, ts=i / FPS, features_l=frames[i][0],
                                  features_r=frames[i][1])
            if sys_.imu_initialized and not imu_frame:
                imu_frame.append(i)
        states(sys_, feed, n)
        if letter == "F":
            rmse, s, _ = ate(sys_, pos, with_scale=True, half=True)
        else:
            rmse = ate(sys_, pos, with_scale=False)[0]
            s = ate(sys_, pos)[1]
        return dict(resets=sys_.n_resets, imu_frame=imu_frame, rmse=rmse, scale=s,
                    n_kf=int(sys_.map.n_kf))
    if letter == "J":
        cfgs, rect = T._jax_j_setup()
        pairs, imu = T._jax_j_inputs(70, rect)
        sys_ = jsis.StereoInertialSystem(*cfgs)
        imu_frame = []

        def feed(i):
            for sample in imu[i]:
                sys_.grab_imu(*sample)
            sys_.track_stereo(jnp.asarray(pairs[i][0]), jnp.asarray(pairs[i][1]), ts=i / 10.0)
            if sys_.imu_initialized and not imu_frame:
                imu_frame.append(i)
        st, init = states(sys_, feed, 70)
        rmse = ate(sys_, T._jax_j_pos, with_scale=False)[0]
        s = ate(sys_, T._jax_j_pos)[1]
        return dict(resets=sys_.n_resets, state=int(sys_.state), init=init,
                    n_ok=st.count(jsystem.OK), imu_frame=imu_frame, rmse=rmse, scale=s,
                    n_kf=int(sys_.map.n_kf))
    if letter == "H":
        poses, world = T._jax_ring_poses(270), RingWorld()
        sys_ = jsystem.System(H.jax_config(acc.h_config()))
        states(sys_, lambda i: sys_.track_monocular(
            None, ts=i * 0.05, features=world.frame(*poses[i][:2])), 270)
        rmse, s, _ = ate(sys_, lambda ts: poses[int(round(ts / 0.05))][2])
        return dict(resets=sys_.n_resets, ate=rmse, n_kf=int(sys_.map.n_kf),
                    loops=sys_.loop_closer.n_loops_closed)
    poses, world = camera_path(60), SyntheticWorld(seed=1)
    sys_ = jsystem.System(H.jax_config(acc.i_config()))
    states(sys_, lambda i: sys_.track_monocular(
        None, ts=i * 0.05, features=world.frame(*poses[i][:2])), 60)
    rmse, s, _ = ate(sys_, lambda ts: poses[int(round(ts / 0.05))][2])
    return dict(resets=sys_.n_resets, poses=len(sys_.trajectory), ate=rmse,
                n_kf=int(sys_.map.n_kf), n_pt=int(sys_.map.n_pt))


def _seeds(lo: int, hi: int) -> None:
    import torch
    from orbslam3_tpu_torch.features.extractor import extract
    from orbslam3_tpu_torch.pipeline import system
    from orbslam3_tpu_torch.utils import acceptance as acc
    ffs = [extract(torch.from_numpy(img), acc.orb_params())
           for img in acc.sweep_images(True)[0]]
    for seed in range(lo, hi):
        sys_ = system.System(acc.frontend_config(), device="cpu", seed=seed)
        d = acc.drive(sys_, len(ffs), lambda s, i: s.track_monocular(
            None, ts=i / 10.0, features=ffs[i]), torch.device("cpu"))
        print(f"B seed {seed}: initialized at frame {d.init_frame}, "
              f"{sum(s == system.OK for s in d.states)} of {len(ffs)} OK", flush=True)


def _cut(n8: int, n11c: int, after_imu: dict) -> None:
    from orbslam3_tpu_torch.pipeline import stereo_inertial_system as sis
    from orbslam3_tpu_torch.utils import acceptance as acc
    from orbslam3_tpu_torch.utils import imu_scene
    from orbslam3_tpu_torch.utils import sensor_scene as ss
    if n8:
        cfg = imu_scene.InertialScene(frames=n8, viba1_by=n8 - 1)
        sys_, d = imu_scene.drive(cfg, imu_scene.render_frames(cfg), "cpu")
        print(f"phase 8 at {n8} frames: {imu_scene.check_gates(cfg, sys_, d)}", flush=True)
    if n11c:
        scn = ss.FisheyeSIScene(frames=n11c)
        images = scn.render()
        sys_ = sis.StereoInertialSystem(*scn.configs(), device="cpu")
        d = ss.drive(sys_, range(n11c), ss.fisheye_si_step(scn, images))
        print(f"phase 11c at {n11c} frames: {ss.check_fisheye_si_gates(scn, sys_, d)}",
              flush=True)
    for letter, n in after_imu.items():
        r = acc.SCENARIOS[letter]("cpu", after_imu=n)
        print(f"phase 16 {letter} to its IMU initialization + {n} frames: {r['frames']} "
              f"frames, the IMU at frame {r['imu_frame']}, bad {r['bad']}, gates "
              f"{json.dumps(r['gates'], default=str)}, {r['seconds']:.1f} s", flush=True)


def _floats() -> None:
    import tempfile

    import jax.numpy as jnp
    import torch
    import test_torch_acceptance as T
    import torch_parity_helpers as H
    from orbslam3_tpu.features import extractor as jx
    from orbslam3_tpu.pipeline import stereo_inertial_system as jsis
    from orbslam3_tpu_torch import config as presets
    from orbslam3_tpu_torch.pipeline import stereo_inertial_system as tsis
    from orbslam3_tpu_torch.slam_map import convert
    from orbslam3_tpu_torch.tools import run_euroc
    from orbslam3_tpu_torch.utils import acceptance as acc
    from orbslam3_tpu_torch.utils import tumvi_scene

    # J's first tracked frame: the predicted scale levels at the init pose
    rect = acc.j_rectification()
    sys_ = tsis.StereoInertialSystem(*acc.j_configs(rect), device="cpu")
    sys_.track_stereo(*acc.j_pairs(range(1), rect)[0], ts=0.0)
    v = sys_.view
    dist = torch.linalg.norm(v.xyz @ sys_.R_cur.T + sys_.t_cur, dim=-1)
    lv = (torch.log(v.max_dist / dist) / torch.log(torch.tensor(1.2)))[v.valid]
    off = lv - torch.round(lv)
    print(f"J at the init pose: {len(lv)} view points, predicted-level argument within "
          f"{float(off.abs().max()):.3g} of an integer, {int((off > 0).sum())} just above it",
          flush=True)
    # JAX and the port from their own maps, then the port from JAX's state
    jcfgs, jrect = T._jax_j_setup()
    pairs, imu = T._jax_j_inputs(3, jrect)
    feats = [[jx.extract_jit(jnp.asarray(img), jcfgs[0].orb) for img in pr] for pr in pairs]
    jsys = jsis.StereoInertialSystem(*jcfgs)
    own, given = (tsis.StereoInertialSystem(*acc.j_configs(rect), device="cpu")
                  for _ in range(2))

    def feed(s, i):
        for sample in imu[i]:
            s.grab_imu(*sample)
        (fl, fr), (il, ir) = feats[i], pairs[i]
        if isinstance(s, jsis.StereoInertialSystem):
            s.track_stereo(jnp.asarray(il), jnp.asarray(ir), ts=i / 10.0, features_l=fl,
                           features_r=fr)
        else:
            s.track_stereo(il, ir, ts=i / 10.0,
                           features_l=convert.frame_from_numpy(H.fields(fl)),
                           features_r=convert.frame_from_numpy(H.fields(fr)))
    for s in (jsys, own, given):
        feed(s, 0)
    gap = np.abs(convert.to_numpy(own.map)["pt_xyz"] - H.fields(jsys.map)["pt_xyz"]).max()
    H.load_inertial_snapshot(H.inertial_snapshot(jsys), given)
    H.copy_keyframe_db(jsys, given)
    for i in (1, 2):
        for s in (jsys, own, given):
            feed(s, i)
        pj = np.asarray(jsys.t_cur)
        print(f"J frame {i}: inliers JAX {jsys.last_track_inliers}, port from its own map "
              f"{own.last_track_inliers} (points within {gap:.3g} of JAX's; pose "
              f"{np.abs(own.t_cur.numpy() - pj).max():.3g} apart), from JAX's state "
              f"{given.last_track_inliers} ({np.abs(given.t_cur.numpy() - pj).max():.3g} apart)",
              flush=True)
    # the rectification maps' extent in the raw image
    *_, t0, t1 = presets.tumvi_stereo_inertial()
    for name, maps in (("J", rect[:2]), ("TUM-VI", (t0, t1))):
        ext = [(float(m[..., k].min()), float(m[..., k].max())) for m in maps for k in (0, 1)]
        print(f"{name} rectification maps sample x, y in {ext} (cam0 x, cam0 y, cam1 x, "
              f"cam1 y)", flush=True)
    # both runners on a short TUM-VI tree
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
    import run_euroc as jax_run_euroc
    with tempfile.TemporaryDirectory() as tmp:
        root = tumvi_scene.write_tree(os.path.join(tmp, "seq"), 8)
        args = [root, "--dataset", "tumvi", "--mode", "stereo-inertial", "--features", "1000",
                "--max-frames", "4", "--out"]
        old = sys.argv
        sys.argv = ["run_euroc.py"] + args + [os.path.join(tmp, "jax.txt")]
        try:
            jax_run_euroc.main()
        finally:
            sys.argv = old
        run_euroc.main(args + [os.path.join(tmp, "port.txt"), "--device", "cpu"])
        j, t = (np.loadtxt(os.path.join(tmp, f)) for f in ("jax.txt", "port.txt"))
    print(f"TUM-VI short tree, 4 frames: the runners' positions {np.abs(t[:, 1:4] - j[:, 1:4]).max():.3g}"
          f" and quaternions {np.abs(t[:, 4:] - j[:, 4:]).max():.3g} apart", flush=True)


def main(argv) -> int:
    import torch
    torch.set_num_threads(2)
    what, args = argv[0], argv[1:]
    if what == "seeds":
        _seeds(int(args[0]), int(args[1]))
    elif what == "cut":
        _cut(int(args[0]), int(args[1]),
             {k: int(v) for k, v in zip("JGF", args[2:5])})
    elif what == "floats":
        import conftest  # noqa: F401  (pins JAX to the CPU)
        _floats()
    else:
        if what == "jax":
            import conftest  # noqa: F401  (pins JAX to the CPU)
        from orbslam3_tpu_torch.utils import acceptance as acc
        for letter in args:
            t0 = time.perf_counter()
            r = _jax(letter) if what == "jax" else acc.SCENARIOS[letter]("cpu")
            r = {k: v for k, v in r.items() if k not in ("last_closure",)}
            print(f"{what} {letter} ({time.perf_counter() - t0:.1f} s): "
                  f"{json.dumps(r, default=str)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
