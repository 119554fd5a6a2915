"""The port's per-frame slice against the JAX package and against ground truth.

`chip_smoke.py`'s seeded-map tracking loop at a small size runs through both
packages on the same rendered frames; both must hold the smoke's gates on
every tracked frame, and must agree with each other.  A full-size version
(the smoke's own configuration) is marked slow.

Also here: the port and `chip_smoke.py` import with JAX and the JAX package
blocked (the native ingest loads the port's own build, never the JAX
package's `native/libingest.so`), and `chip_smoke.py` refuses to report
without a card or without the rest of the repository.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu_torch.ops import orb_patches
from orbslam3_tpu_torch.utils import seeded_scene as ss

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_both(cfg):
    frames = ss.render_frames(cfg)
    mt, _, vt = ss.seed_map(cfg, frames, "cpu")
    orb_patches.reset_counters()
    mt, res_t, _ = ss.track(cfg, mt, vt, frames, "cpu")
    mj, _, vj = H.seed_map_jax(cfg, frames)
    mj, res_j = H.track_jax(cfg, mj, vj, frames)
    return res_t, res_j, mt, mj


def _check(cfg, res_t, res_j, mt, mj):
    assert ss.check_gates(cfg, res_t) == []
    assert ss.check_gates(cfg, res_j) == []
    for (fi, Rt, tt, nt), (fj, Rj, tj, nj) in zip(res_t, res_j):
        assert fi == fj
        # the two packages see the same seeded map and the same keypoints;
        # their poses agree to well inside the gates (float32 sums in the
        # pose optimizer run in another order)
        np.testing.assert_allclose(Rt, Rj, atol=1e-4)
        np.testing.assert_allclose(tt, tj, atol=1e-3)
        assert abs(nt - nj) <= 0.01 * nj, (fi, nt, nj)
    # CPU tensors ran the twins: no kernel was launched
    assert set(orb_patches.launch_counts().values()) == {0}
    assert int(mt.pt_found.sum()) == pytest.approx(int(np.asarray(mj.pt_found).sum()), rel=0.01)


def test_seeded_slice_small_matches_jax_and_ground_truth():
    cfg = H.SMALL
    _check(cfg, *_run_both(cfg))


@pytest.mark.slow
def test_seeded_slice_full_size_matches_jax_and_ground_truth():
    cfg = ss.SceneConfig()
    _check(cfg, *_run_both(cfg))


_NO_JAX = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["orbslam3_tpu"] = None
import orbslam3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(orbslam3_tpu_torch.__path__,
                                               "orbslam3_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("geometry.twoview", "slam_map.atlas", "utils.align", "pipeline.system",
             "place.vocab", "place.keyframe_db", "geometry.mlpnp", "pipeline.relocalization",
             "pipeline.loop_closing", "ops.imu", "solver.inertial", "solver.vi_ba",
             "solver.vi_pose_opt", "pipeline.inertial_system", "utils.imu_scene",
             "ops.align", "geometry.sim3solver", "solver.pose_graph", "utils.loop_scene",
             "features.stereo", "pipeline.stereo_system", "pipeline.rgbd_system",
             "pipeline.stereo_inertial_system", "io.euroc", "io.rectify", "config",
             "utils.sensor_scene", "eval.ate", "io.native_ingest", "io.pump",
             "utils.profiling", "utils.euroc_scene", "viz", "viz_server", "tools.run_euroc",
             "tools.drives.drive_loop", "utils.synthetic_world", "tools.drives.drive_extract_bench",
             "tools.drives.drive_kf_times", "tools.drives.drive_vi_gnss",
             "tools.drives.drive_vi_loop", "tools.drives.drive_vi_chain_ablation",
             "tools.train_vocab", "tools.vocab_recall_curve", "parallel", "parallel.dist_ba",
             "parallel.multihost", "graft_entry", "tools.bench_multihost",
             "tools.drives.drive_pod_scale", "utils.engine_mesh", "utils.gba_repeat",
             "utils.dist_scene", "utils.seg_sum_bench", "bench"):
    assert "orbslam3_tpu_torch." + name in names, name
from orbslam3_tpu_torch.pipeline.system import SlamConfig, System
sys_ = System(SlamConfig(), device="cpu")
assert sys_.state == 0 and sys_.loop_closer.db.tf.shape == (256, 65536)
sys_ = System(SlamConfig(async_mapping=True, enable_loop_closing=True), device="cpu")
assert sys_._pending is None and sys_.loop_closer is not None
from orbslam3_tpu_torch.pipeline.inertial_system import InertialConfig, InertialSystem
isys = InertialSystem(SlamConfig(enable_relocalization=False), InertialConfig(), device="cpu")
assert isys.state == 0 and not isys.imu_initialized
from orbslam3_tpu_torch import config
from orbslam3_tpu_torch.pipeline.stereo_inertial_system import StereoInertialSystem
cfg, icfg, scfg, map0, map1 = config.tumvi_stereo_inertial(enable_relocalization=False)
assert StereoInertialSystem(cfg, icfg, scfg, device="cpu").imu_fix_scale
from orbslam3_tpu_torch.io import native_ingest
if native_ingest.available():
    assert "orbslam3_tpu/native" not in native_ingest._lib()._name
import chip_smoke
assert "jax" not in [m.split(".")[0] for m, v in sys.modules.items() if v is not None]
print(len(names))
"""


def test_port_and_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 100   # every module of the package


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_refuses_without_a_card():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
