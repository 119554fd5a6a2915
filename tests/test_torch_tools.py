"""The port's tools and their modules against the JAX package's: the ATE
(association, float32 Umeyama alignment), the synthetic textures and the
photometric stress, the continuous-rotation rBRIEF, the stage timer, the
plots and the live viewer, and the sequence runner's mono arm on a 12-frame
EuRoC-layout tree on the CPU.

Tolerances: the textures, the stress model and the descriptors are
bit-equal; the ATE's rmse, median and scale agree within 1e-5 relative and
its pairs exactly (both align in float32).
"""

import contextlib
import io
import json
import os
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from orbslam3_tpu.eval import ate as jate
from orbslam3_tpu.ops import align as jalign
from orbslam3_tpu.utils import synth_render as jsr
from orbslam3_tpu_torch import config as presets
from orbslam3_tpu_torch import viz, viz_server
from orbslam3_tpu_torch.eval import ate as tate
from orbslam3_tpu_torch.features import extractor
from orbslam3_tpu_torch.io import euroc, native_ingest, pump
from orbslam3_tpu_torch.ops import align as talign
from orbslam3_tpu_torch.pipeline import system
from orbslam3_tpu_torch.tools import run_euroc
from orbslam3_tpu_torch.utils import euroc_scene as es
from orbslam3_tpu_torch.utils import profiling
from orbslam3_tpu_torch.utils import synth_render as tsr

torch.set_num_threads(2)

N_TREE = 12
EPOCH = 1403636579763555584 * 1e-9


# --------------------------------------------------------------------- ATE
def _trajectories(seed, n=80, t0=0.0):
    rng = np.random.default_rng(seed)
    gt_ts = t0 + np.arange(n * 2) * 0.01
    gt = np.cumsum(rng.normal(0, 0.05, (n * 2, 3)), axis=0)
    # the estimate: every other stamp jittered by a few ms, a similarity
    # away from the ground truth plus noise, some stamps missing
    keep = np.sort(rng.choice(np.arange(0, n * 2, 2), n - 10, replace=False))
    est_ts = gt_ts[keep] + rng.uniform(-0.004, 0.004, keep.size)
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    est = 0.37 * gt[keep] @ R.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.01, (keep.size, 3))
    return est_ts, est, gt_ts, gt


@pytest.mark.parametrize("t0", [0.0, EPOCH])
def test_associate_matches_jax(t0):
    est_ts, _, gt_ts, _ = _trajectories(0, t0=t0)
    for max_dt in (0.02, 0.003):
        assert tate.associate(est_ts, gt_ts, max_dt) == jate.associate(est_ts, gt_ts, max_dt)
    assert len(tate.associate(est_ts, gt_ts)) == est_ts.size


@pytest.mark.parametrize("t0,with_scale", [(0.0, True), (0.0, False), (EPOCH, True)])
def test_evaluate_ate_matches_jax(t0, with_scale):
    args = _trajectories(1, t0=t0)
    rt = tate.evaluate_ate(*args, with_scale=with_scale)
    rj = jate.evaluate_ate(*args, with_scale=with_scale)
    assert rt["n_pairs"] == rj["n_pairs"] > 3
    for k in ("rmse", "mean", "median", "scale"):
        assert rt[k] == pytest.approx(rj[k], rel=1e-5), k
    if with_scale:
        assert rt["scale"] == pytest.approx(1 / 0.37, rel=1e-2)
    # fewer than 3 pairs: the sentinel
    short = tate.evaluate_ate(args[0][:2], args[1][:2], args[2], args[3])
    assert short == jate.evaluate_ate(args[0][:2], args[1][:2], args[2], args[3])


@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_rmse_and_horn_match_jax(with_scale):
    import jax.numpy as jnp
    _, est, _, gt = _trajectories(2)
    e, g = est.astype(np.float32), gt[:est.shape[0]].astype(np.float32)
    rt, st, Rt, tt = talign.ate_rmse(torch.from_numpy(e), torch.from_numpy(g), with_scale)
    rj, sj, Rj, tj = jalign.ate_rmse(jnp.asarray(e), jnp.asarray(g), with_scale)
    assert rt.dtype == torch.float32
    assert float(rt) == pytest.approx(float(rj), rel=1e-5)
    assert float(st) == pytest.approx(float(sj), rel=1e-5)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5, atol=1e-5)
    Rh, th = talign.horn_alignment(torch.from_numpy(e), torch.from_numpy(g))
    Rhj, thj = jalign.horn_alignment(jnp.asarray(e), jnp.asarray(g))
    np.testing.assert_allclose(Rh.numpy(), np.asarray(Rhj), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(thj), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- synthetic world
@pytest.mark.parametrize("name", ["voronoi_texture", "stripe_texture", "blob_texture",
                                  "block_texture", "default_mesas"])
def test_textures_and_mesas_bit_equal(name):
    kw = {} if name == "default_mesas" else {"size": 256}
    a = getattr(tsr, name)(np.random.default_rng(5), **kw)
    b = getattr(jsr, name)(np.random.default_rng(5), **kw)
    if name == "default_mesas":
        assert a == b and len(a) == 24
        assert tsr.DEFAULT_MESAS == jsr.DEFAULT_MESAS
    else:
        assert a.dtype == np.float32 and a.shape == (256, 256)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(exposure=0.45, gamma=1.2, vignette=0.45, blur_px=2.5, blur_dir=(1.0, 0.4), noise=10.0),
    dict(exposure=1.3, blur_px=0.5, noise=0.0),
    dict(gamma=0.8, blur_px=4.0, blur_dir=(0.0, 1.0), noise=3.0),
])
def test_photometric_stress_bit_equal(kw):
    tex = tsr.block_texture(np.random.default_rng(7), size=256, block=10)
    R_cw, t_cw = tsr.look_down_pose(1.0, 2.0, 5.0, yaw=0.3)
    img = tsr.render_plane(R_cw, t_cw, np.asarray((230.0, 230.0, 188.0, 120.0)), (120, 188),
                           tex, tex_scale=40.0, mesas=tsr.DEFAULT_MESAS)
    np.testing.assert_array_equal(
        img, jsr.render_plane(R_cw, t_cw, np.asarray((230.0, 230.0, 188.0, 120.0)), (120, 188),
                              tex, tex_scale=40.0))
    a = tsr.photometric_stress(img, rng=np.random.default_rng(9), **kw)
    b = jsr.photometric_stress(img, rng=np.random.default_rng(9), **kw)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_compute_descriptors_exact_bit_equal():
    import jax.numpy as jnp
    from orbslam3_tpu.ops import brief as jbrief
    from orbslam3_tpu_torch.ops import brief as tbrief
    from orbslam3_tpu_torch.ops import image
    tex = tsr.block_texture(np.random.default_rng(3), size=512, block=10)
    R_cw, t_cw = tsr.look_down_pose(2.0, 2.0, 3.0, yaw=0.2)
    img = tsr.render_plane(R_cw, t_cw, np.asarray((400.0, 400.0, 188.0, 120.0)), (240, 376),
                           tex, tex_scale=60.0, mesas=())
    blurred = torch.round(image.gaussian_blur(torch.from_numpy(img)))
    rng = np.random.default_rng(4)
    xy = rng.uniform(-4, 380, (700, 2)).astype(np.float32)
    ang = rng.uniform(0, 360, 700).astype(np.float32)
    ang[:32] = np.arange(32) * 11.25           # bin centres: rounding ties
    dt = tbrief.compute_descriptors_exact(blurred, torch.from_numpy(xy), torch.from_numpy(ang))
    dj = jbrief.compute_descriptors_exact(jnp.asarray(blurred.numpy()), jnp.asarray(xy),
                                          jnp.asarray(ang))
    assert dt.dtype == torch.int32 and dt.shape == (700, 8)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj).view(np.int32))


# ---------------------------------------------------------------- profiling
def test_stage_timer_summary_matches_jax():
    from orbslam3_tpu.utils import profiling as jprof
    tt, tj = profiling.StageTimer(), jprof.StageTimer()
    for name, secs in (("track", [0.0123, 0.0151, 0.0110]), ("kf_step", [0.2]),
                       ("extract", [0.004, 0.005])):
        for s in secs:
            tt.record(name, s)
            tj.record(name, s)
    assert tt.summary() == tj.summary()
    assert re.match(r"^extract +n= +2 median= +4\.50ms p90= +4\.90ms mean= +4\.50ms$",
                    tt.summary().splitlines()[0])
    with tt.stage("synced", sync=(torch.zeros(3), {"a": [torch.ones(2)]})):
        time.sleep(0.002)
    assert tt.times["synced"][0] >= 0.002


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "prof" / "trace.json"
    assert "traceEvents" in json.loads(path.read_text())
    assert "profile written to" in capsys.readouterr().out


# ------------------------------------------------- the tool on a 12-frame tree
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return es.write_tree(str(tmp_path_factory.mktemp("euroc12")), N_TREE)


@pytest.fixture(scope="module")
def mono_run(tree, tmp_path_factory):
    """The tool's mono arm on the 12-frame tree on the CPU, with its output,
    its TUM file, its map plot, and the images that reached `extract`."""
    out_dir = tmp_path_factory.mktemp("mono_run")
    traj, plot = str(out_dir / "traj.txt"), str(out_dir / "map.png")
    seen = []
    real = extractor.extract

    def spy(img, p):
        seen.append((img.dtype, bool(torch.any(img != torch.round(img)))))
        return real(img, p)

    frames = []
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(extractor, "extract", spy)
        res = run_euroc.main([tree, "--mode", "mono", "--max-frames", str(N_TREE), "--out",
                              traj, "--viz", plot, "--device", "cpu"],
                             on_frame=lambda *a: frames.append(a))
    return dict(res=res, out=buf.getvalue(), traj=traj, plot=plot, seen=seen, frames=frames)


def test_tool_mono_arm_prints_jax_lines_and_writes_a_tum_file(mono_run, tree):
    out = mono_run["out"].splitlines()
    assert out[0] == "ingest: native"
    assert re.fullmatch(r"frame 0/12 state=\d+ kf=\d+ \(\d+s\)", out[1]), out
    assert re.fullmatch(r"processed 12 frames in \d+\.\ds \(\d+\.\d fps\), resets=0", out[2])
    assert out[3] == f"trajectory -> {mono_run['traj']}"
    assert out[4] == f"map plot -> {mono_run['plot']}"
    m = re.fullmatch(r"ATE: rmse=(\d+\.\d{4}) m  median=(\d+\.\d{4}) m  "
                     r"scale=(\d+\.\d{3})  pairs=(\d+)", out[5])
    assert m, out
    sys_ = mono_run["res"]["system"]
    assert sys_.state == system.OK and sys_.n_resets == 0
    assert sys_.map.pt_xyz.device.type == "cpu"
    lines = open(mono_run["traj"]).read().splitlines()
    assert len(lines) == len(sys_.trajectory) > N_TREE // 2
    for ln, (ts, _, twc) in zip(lines, sys_.trajectory):
        f = ln.split()
        assert len(f) == 8 and all(re.fullmatch(r"-?\d+\.\d{6}", x) for x in f)
        assert float(f[0]) == pytest.approx(ts, abs=1e-6)
        np.testing.assert_allclose([float(x) for x in f[1:4]], twc, atol=1e-6)
    # the printed ATE is the JAX package's oracle on the same trajectory
    seq = euroc.EurocSequence(tree)
    gt_ts, gt_xyz = seq.read_groundtruth()
    rj = jate.evaluate_ate(np.asarray([p[0] for p in sys_.trajectory]),
                           np.stack([p[2] for p in sys_.trajectory]), gt_ts, gt_xyz)
    assert float(m.group(1)) == pytest.approx(rj["rmse"], abs=1e-4)
    assert int(m.group(4)) == rj["n_pairs"] == len(sys_.trajectory)
    assert mono_run["res"]["ate"]["rmse"] < 0.15 * es.span(N_TREE)
    assert open(mono_run["plot"], "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_tool_hands_extract_float32_frames_with_fractions(mono_run):
    """The ingest's bilinear frames reach `extract` as float32, fractions
    included (rounding them to uint8 would move FAST's keypoints)."""
    assert len(mono_run["seen"]) == N_TREE
    assert all(dt == torch.float32 for dt, _ in mono_run["seen"])
    assert all(frac for _, frac in mono_run["seen"])


def test_tool_on_frame_hook_sees_every_frame(mono_run):
    frames = mono_run["frames"]
    assert [f[0] for f in frames] == list(range(N_TREE))
    i, sys_, before, track_s, ingest_s = frames[-1]
    assert sys_ is mono_run["res"]["system"] and len(before) == 3
    assert track_s > 0 and ingest_s >= 0


def test_tool_refuses_rgbd_with_tumvi(tree, capsys):
    with pytest.raises(SystemExit) as e:
        run_euroc.main([tree, "--mode", "rgbd", "--dataset", "tumvi", "--device", "cpu"])
    assert e.value.code == 2
    assert "--dataset tumvi (raw KB8 fisheye) is not a valid combination" in \
        capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_tool_refuses_the_card_without_one(tree, capsys):
    with pytest.raises(SystemExit):
        run_euroc.main([tree, "--max-frames", "2"])
    assert "pass --device cpu" in capsys.readouterr().err


def test_tool_says_when_it_takes_the_host_decoder(tree, capsys, monkeypatch):
    """Where the native ingest does not build, the run says so and why on
    its first line, and the host path's frames are JAX's host frames."""
    monkeypatch.setattr(native_ingest, "_LIB", None)
    monkeypatch.setattr(native_ingest, "_ERROR", "native ingest library unavailable: "
                        "g++ failed (1): png.h: No such file or directory")
    res = run_euroc.main([tree, "--max-frames", "4", "--device", "cpu", "--clahe", "2.0"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("ingest: host (native ingest library unavailable: g++ failed (1): "
                      "png.h: No such file or directory; no CLAHE)")
    assert res["decoder"] == "host" and "processed 4 frames" in out[2]
    from orbslam3_tpu.io import euroc as jeuroc
    seq = euroc.EurocSequence(tree)
    seq.images = seq.images[:3]
    cam = euroc.EUROC_CAM0
    umap = euroc.undistort_map(cam["params"], cam["distortion"], cam["resolution"])
    got = [f.image for f in pump.pump_euroc(seq, remap=umap, n_threads=2)]
    jseq = jeuroc.EurocSequence(tree)
    for rec, img in zip(jseq.images, got):
        np.testing.assert_array_equal(img, jeuroc.apply_undistort(jseq.load_image(rec), umap))


# ------------------------------------------------------- plots and viewer
def test_plot_map_and_frame_write_pngs(mono_run, tree, tmp_path):
    sys_ = mono_run["res"]["system"]
    edges = viz.covisibility_edges(sys_, min_weight=15)
    assert edges.ndim == 3 and edges.shape[1:] == (2, 3) and len(edges) >= 1
    seq = euroc.EurocSequence(tree)
    img = seq.load_image(seq.images[-1])
    ff = extractor.extract(torch.from_numpy(img), sys_.cfg.orb)
    kp_pt = sys_.last_kp_pt
    assert kp_pt is not None and int((kp_pt >= 0).sum()) > 50
    for path in (viz.plot_frame(img, ff, kp_pt, str(tmp_path / "f.png")),
                 viz.plot_map(sys_, str(tmp_path / "m.png"))):
        assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    sv = viz.StepViewer(str(tmp_path / "steps"), map_every=1)
    outs = sv.on_frame(sys_, img, ff, kp_pt)
    assert len(outs) == 2 and all(os.path.exists(p) for p in outs)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read()


def test_viewer_server_with_a_live_system(tree):
    """test_viewer.py's checks on the port: the page, the state JSON of a
    live map, the pause / step / resume gate of the tracking loop, and the
    annotated frame stream."""
    from PIL import Image
    cam = euroc.EUROC_CAM0
    umap = euroc.undistort_map(cam["params"], cam["distortion"], cam["resolution"])
    seq = euroc.EurocSequence(tree)
    frames = [(f.ts, f.image) for f in pump.pump_euroc(seq, remap=umap, n_threads=2)]
    sys_ = system.System(presets.euroc_mono(), device="cpu")
    viewer = viz_server.ViewerServer(port=0, frame_every=1)
    viewer.attach(sys_)
    try:
        pngs = []
        for ts, img in frames[:N_TREE - 1]:
            sys_.track_monocular(img, ts)
            pngs.append(_get(viewer.port, "/frame.png"))
        assert sys_.state == system.OK
        page = _get(viewer.port, "/").decode()
        assert "orbslam3_tpu viewer" in page and "fetch(" in page
        st = json.loads(_get(viewer.port, "/state.json"))
        assert st["n_kf"] >= 2 and st["n_pts"] > 100
        assert len(st["points"]) > 100 and len(st["traj"]) > 5
        assert st["cam"] is not None and st["state"] == system.OK
        np.testing.assert_allclose(st["cam"], sys_.trajectory[-1][2], atol=1e-3)
        # the frame stream: PNGs that change, with the coloured overlay
        assert pngs[-1][:8] == b"\x89PNG\r\n\x1a\n" and pngs[-1] != pngs[0]
        arr = np.asarray(Image.open(io.BytesIO(pngs[-1])).convert("RGB"))
        assert np.abs(arr[..., 1].astype(int) - arr[..., 2].astype(int)).max() > 50
        # pause blocks the tracking loop; step releases exactly one frame
        _get(viewer.port, "/control?cmd=pause")
        done = threading.Event()

        def run_one():
            sys_.track_monocular(frames[-1][1], frames[-1][0])
            done.set()

        th = threading.Thread(target=run_one, daemon=True)
        th.start()
        time.sleep(0.4)
        assert not done.is_set(), "tracking loop did not pause"
        _get(viewer.port, "/control?cmd=step")
        th.join(timeout=30)
        assert done.is_set(), "step did not release the frame"
        assert viewer.paused
        _get(viewer.port, "/control?cmd=resume")
        assert not viewer.paused
    finally:
        sys_.shutdown()
    assert sys_.viewer is None
