"""The CPU numbers that PERF.md, ROADMAP.md and tests/test_torch_acceptance.py
quote beside the acceptance scenarios (`orbslam3_tpu_torch/utils/acceptance.py`).

    JAX_PLATFORMS=cpu python tests/acceptance_numbers.py jax A B C D E F G H I
    python tests/acceptance_numbers.py port A B C D E F G H I
    python tests/acceptance_numbers.py seeds 0 12        # B under System seeds 0..11
    python tests/acceptance_numbers.py cut 72 40         # smoke phases 8 and 11c, cut

`jax`: each JAX test's drive on the JAX package, on the inputs the JAX test
builds (the builders of tests/test_torch_acceptance.py, which are the JAX
tests' own code), printing the values its gates read.  `port`: the port's
`run_<letter>("cpu")`.  `seeds`: scenario B on the port with other seeds of
the System's RANSAC generator (its initialization frame and frames OK).
`cut`: chip_smoke.py's phase 8 and 11c drives at the given depths on the
CPU, with their gates.  Not a test module: pytest does not collect it.
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


def _cut(n8: int, n11c: int) -> None:
    from orbslam3_tpu_torch.pipeline import stereo_inertial_system as sis
    from orbslam3_tpu_torch.utils import imu_scene
    from orbslam3_tpu_torch.utils import sensor_scene as ss
    cfg = imu_scene.InertialScene(frames=n8, viba1_by=n8 - 1)
    sys_, d = imu_scene.drive(cfg, imu_scene.render_frames(cfg), "cpu")
    print(f"phase 8 at {n8} frames: {imu_scene.check_gates(cfg, sys_, d)}", flush=True)
    scn = ss.FisheyeSIScene(frames=n11c)
    images = scn.render()
    sys_ = sis.StereoInertialSystem(*scn.configs(), device="cpu")
    d = ss.drive(sys_, range(n11c), ss.fisheye_si_step(scn, images))
    print(f"phase 11c at {n11c} frames: {ss.check_fisheye_si_gates(scn, sys_, d)}", flush=True)


def main(argv) -> int:
    import torch
    torch.set_num_threads(2)
    what, args = argv[0], argv[1:]
    if what == "seeds":
        _seeds(int(args[0]), int(args[1]))
    elif what == "cut":
        _cut(int(args[0]), int(args[1]))
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
