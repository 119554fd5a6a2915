"""The port's checkpoint against the JAX package's file layout, both ways:
`load_system` restores a session that the JAX package saved (the same map,
bank, database and host mirrors as the JAX package's own restore, and both
restored Systems then track the same frames alike); the JAX `load_map` reads
the file that the port writes, array for array; and the port's own session
resumes from its own file, keeps tracking without overwriting a keyframe
slot and relocalizes against the restored database
(`tests/test_atlas_reloc.py::TestCheckpointResume`'s gates).  The inertial
twin of `tests/test_inertial_checkpoint.py` is marked slow, as that test is.
Each test states its tolerance.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu.slam_map import checkpoint as jckpt
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.pipeline import inertial_system as tis
from orbslam3_tpu_torch.pipeline import relocalization as treloc
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import checkpoint as tckpt
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map.state import MapCapacity
from orbslam3_tpu_torch.utils import align as talign
from test_inertial_pipeline import FPS, IMU_HZ, camera_path_smooth
from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path
from test_torch_inertial_system import _imu_samples

torch.set_num_threads(2)

CAP = dict(n_kf=32, n_pt=4096, n_obs=32768)
COMMON = dict(cam_params=K4, image_hw=HW, min_init_matches=80, max_frames_between_kf=6,
              ba_caps=(24, 4096, 16384), local_view_points=2048)
DT = 0.05
N_BOOT, N_MORE = 24, 12


def _tsys():
    return tsystem.System(tsystem.SlamConfig(map_capacity=MapCapacity(**CAP), **COMMON),
                          device="cpu")


def _jff(f):
    return jsystem.FeatureFrame(**{k: jnp.asarray(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX System (keyframe database on) driven over the first 24 frames of
    TestCheckpointResume's world and saved by the JAX package; the frames
    24-35 and a fresh frame from frame 10's viewpoint, drawn in that order
    (the world draws its noise frame after frame)."""
    world = SyntheticWorld(seed=9)
    poses = camera_path(60)
    frames = [H.fields(world.frame(R, t)) for R, t, _ in poses[:N_BOOT + N_MORE]]
    revisit = H.fields(world.frame(*poses[10][:2]))
    jsys = jsystem.System(jsystem.SlamConfig(map_capacity=jstate.MapCapacity(**CAP), **COMMON))
    for i in range(N_BOOT):
        jsys.track_monocular(None, ts=i * DT, features=_jff(frames[i]))
    assert jsys.state == jsystem.OK and jsys.n_kf_host >= 3 and jsys.n_resets == 0
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jckpt.save_system(path, jsys)
    return jsys, path, frames, revisit


def test_load_system_restores_a_jax_checkpoint_and_both_continue(saved):
    """The port's `load_system` on the JAX file against the JAX package's
    own `load_system` of it: every map field equal (descriptors as int32 bit
    patterns), the bank equal, the database's registered keyframes equal and
    its term frequencies within 1e-6, the tracker pose and the host mirrors
    (keyframe count, last keyframe, its timestamp, frame counters, state)
    equal.  Then both track frames 24-35: the same state on every frame,
    keyframes inserted on the same frames, poses within 1e-3."""
    jsys, path, frames, _ = saved
    tsys = _tsys()
    tckpt.load_system(path, tsys)
    jckpt.load_system(path, jsys)              # the JAX restore, in place
    g, r = convert.to_numpy(tsys.map), H.fields(jsys.map)
    for name in r:
        ref = r[name].view(np.int32) if r[name].dtype == np.uint32 else r[name]
        np.testing.assert_array_equal(g[name], ref, err_msg=name)
    gb, rb = convert.to_numpy(tsys.bank), H.fields(jsys.bank)
    for name in rb:
        ref = rb[name].view(np.int32) if rb[name].dtype == np.uint32 else rb[name]
        np.testing.assert_array_equal(gb[name], ref, err_msg=name)
    db_t, db_j = convert.to_numpy(tsys.loop_closer.db), H.fields(jsys.loop_closer.db)
    np.testing.assert_array_equal(db_t["active"], db_j["active"])
    np.testing.assert_allclose(db_t["tf"], db_j["tf"], atol=1e-6)
    np.testing.assert_array_equal(tsys.R_cur.numpy(), np.asarray(jsys.R_cur))
    for name in ("n_kf_host", "last_kf_idx", "last_kf_ts", "frame_id", "last_kf_id", "state",
                 "has_velocity"):
        assert getattr(tsys, name) == getattr(jsys, name), name
    assert int(tsys.view.valid.sum()) == int(jsys.view.valid.sum())
    kf_t, kf_j = [], []
    for i in range(N_BOOT, N_BOOT + N_MORE):
        nt, nj = tsys.n_kf_host, jsys.n_kf_host
        sj, pj = jsys.track_monocular(None, ts=i * DT, features=_jff(frames[i]))
        st, pt = tsys.track_monocular(None, ts=i * DT, features=convert.frame_from_numpy(frames[i]))
        assert st == sj == tsystem.OK, i
        kf_t += [i] * (tsys.n_kf_host > nt)
        kf_j += [i] * (jsys.n_kf_host > nj)
        np.testing.assert_allclose(pt[0], pj[0], atol=1e-3, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt[1], pj[1], atol=1e-3, err_msg=f"frame {i}")
    assert kf_t == kf_j and kf_t


def test_jax_load_map_reads_the_port_checkpoint(saved, tmp_path):
    """The port restores the JAX file and saves it again: the JAX package's
    `load_map` reads the port's file with every array equal to the port's map
    (descriptors uint32 on disk) and to the JAX file's; the port's `load_map`
    reads both; the extras hold the same keyframes' features and bindings,
    equal (the bank has no `response`: zeros), and the same counters."""
    _, path, _, _ = saved
    tsys = _tsys()
    tckpt.load_system(path, tsys)
    out = str(tmp_path / "port.npz")
    tckpt.save_system(out, tsys)
    from_port = H.fields(jckpt.load_map(out))
    from_jax = H.fields(jckpt.load_map(path))
    mine = convert.to_numpy(tsys.map)
    for name, a in from_port.items():
        assert a.dtype == from_jax[name].dtype, name
        np.testing.assert_array_equal(a, from_jax[name], err_msg=name)
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.uint32 else a,
                                      mine[name], err_msg=name)
    for p in (path, out):
        back = convert.to_numpy(tckpt.load_map(p))
        for name, a in back.items():
            np.testing.assert_array_equal(a, mine[name], err_msg=name)
    with open(path + ".extras.pkl", "rb") as f:
        ej = pickle.load(f)
    with open(out + ".extras.pkl", "rb") as f:
        et = pickle.load(f)
    assert sorted(et) == sorted(ej)
    for key, v in ej.items():
        if key.startswith("ff_"):
            for name, a in v.items():
                want = np.zeros_like(a) if name == "response" else a
                np.testing.assert_array_equal(et[key][name], want, err_msg=f"{key} {name}")
        elif key.startswith("bind_") or key in ("frame_id", "last_kf_id"):
            np.testing.assert_array_equal(et[key], v, err_msg=key)
    np.testing.assert_allclose(et["R_cur"], ej["R_cur"], atol=1e-7)


def test_session_resumes_tracking_and_relocalizes(saved, tmp_path):
    """TestCheckpointResume on the port: the session restored from the JAX
    file is saved by the port and restored into a fresh System, which keeps
    the host mirrors, tracks frames 24-35 OK with no reset and no keyframe
    slot overwritten (the first keyframes' timestamps intact); a third fresh
    System restored from the port's file relocalizes a frame from frame 10's
    viewpoint against the restored database, its camera centre within 0.05
    of the JAX session's estimate at that frame."""
    jsys, path, frames, revisit = saved
    first = _tsys()
    tckpt.load_system(path, first)
    nk = first.n_kf_host
    out = str(tmp_path / "port.npz")
    tckpt.save_system(out, first)
    sys2 = _tsys()
    tckpt.load_system(out, sys2)
    assert sys2.n_kf_host == nk and abs(sys2.last_kf_ts - first.last_kf_ts) < 1e-5
    assert sys2.state == tsystem.OK
    for i in range(N_BOOT, N_BOOT + N_MORE):
        sys2.track_monocular(None, ts=i * DT, features=convert.frame_from_numpy(frames[i]))
    assert sys2.state == tsystem.OK and sys2.n_resets == 0 and sys2.n_kf_host >= nk
    np.testing.assert_array_equal(sys2.map.kf_ts[:nk].numpy(), first.map.kf_ts[:nk].numpy())
    sys3 = _tsys()
    tckpt.load_system(out, sys3)
    ok, R, t = treloc.attempt_relocalization(sys3, convert.frame_from_numpy(revisit),
                                             sys3.loop_closer)
    assert ok, "relocalization failed against the restored database"
    ref = next(e for e in jsys.trajectory if abs(e[0] - 10 * DT) < 1e-6)
    centre = -R.numpy().T @ t.numpy()
    assert np.linalg.norm(centre - ref[2]) < 0.05


@pytest.mark.slow
def test_inertial_session_resumes_metric(tmp_path):
    """test_inertial_checkpoint.py on the port: a mono-inertial session saved
    at frame 78, after the IMU initialization, restored into a fresh
    InertialSystem (the IMU state, bias within 1e-6, the preintegration chain
    replayed to the same total time within 1e-4, the frame counters), then
    driven to frame 120 with no reset and metric scale (|s - 1| < 0.12 and
    RMSE < 0.12 after alignment with scale)."""
    world = SyntheticWorld(seed=3)
    n_frames, n_cut = 120, 78
    frames, pos, vel, acc, rot, rot_rate = camera_path_smooth(n_frames)
    cfg = tsystem.SlamConfig(cam_params=K4, image_hw=HW, min_init_matches=80,
                             max_frames_between_kf=6, ba_caps=(24, 4096, 16384))
    icfg = tis.InertialConfig(imu_freq=IMU_HZ, init_time_s=1.5, init_min_kfs=5)

    def drive(sys_, lo, hi):
        for i in range(lo, hi):
            for s in _imu_samples(i, rot, rot_rate, acc):
                sys_.grab_imu(*s)
            ff = convert.frame_from_numpy(H.fields(world.frame(*frames[i][:2])))
            sys_.track_monocular(None, ts=i / FPS, features=ff)

    sys1 = tis.InertialSystem(cfg, icfg, device="cpu")
    drive(sys1, 0, n_cut)
    assert sys1.imu_initialized and sys1.n_resets == 0
    path = str(tmp_path / "vi_session.npz")
    tckpt.save_system(path, sys1)
    sys2 = tis.InertialSystem(cfg, icfg, device="cpu")
    tckpt.load_system(path, sys2)
    assert sys2.imu_initialized and sys2.viba1_done == sys1.viba1_done
    assert sys2.preint_kf_pairs == sys1.preint_kf_pairs
    np.testing.assert_allclose(sys2.bias.numpy(), sys1.bias.numpy(), atol=1e-6)
    dT1 = sum(float(p.dT) for p in sys1.preints)
    dT2 = sum(float(p.dT) for p in sys2.preints)
    assert abs(dT1 - dT2) < 1e-4
    assert sys2.frame_id == sys1.frame_id and sys2.last_kf_id == sys1.last_kf_id
    drive(sys2, n_cut, n_frames)
    assert sys2.n_resets == 0 and sys2.state == tsystem.OK and sys2.imu_initialized
    est = np.stack([p[2] for p in sys2.trajectory])
    gt = np.stack([pos(p[0]) for p in sys2.trajectory])
    rmse, s, _, _ = talign.ate_rmse(est, gt, with_scale=True)
    assert abs(s - 1.0) < 0.12, s
    assert rmse < 0.12, rmse
