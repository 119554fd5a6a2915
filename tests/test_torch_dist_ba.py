"""The port's sharded Schur BA (`orbslam3_tpu_torch/parallel/dist_ba.py`)
against the JAX package's on its 8-device virtual CPU mesh.

`partition_problem` field by field at 8 shards, also where a shard
overflows (T13: its dropped rows write their fill into the shard's last
slot, and the last write wins, in both packages).  `dist_bundle_adjust` with
8 local shards against JAX's on `test_dist_ba.synth_problem` for each comm
mode (R and t within 1e-5, X within 1e-4, the cost within 1e-3 relative),
with JAX's own gates (5e-3 to the truth, the modes within 2e-3 of one
another) and the collectives per LM iteration counted.  The dense mode's
shard-local assembly with every (camera, point) pair observed twice (T14)
against JAX's per shard.  And the counterpart of
`test_multihost.py::test_two_process_matches_single_process`: 2 gloo
processes x 2 local shards against 1 process x 4, within JAX's bounds.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from orbslam3_tpu.parallel import dist_ba as jd
from orbslam3_tpu.solver import ba as jba
from orbslam3_tpu_torch.parallel import dist_ba as td
from orbslam3_tpu_torch.parallel import multihost
from orbslam3_tpu_torch.solver import ba as tba
from test_dist_ba import K_EUROC, synth_problem

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = torch.tensor(np.asarray(K_EUROC), dtype=torch.float32)


def _t(prob):
    return tba.BAProblem(*(None if x is None else torch.from_numpy(np.array(x))
                           for x in prob))


def _jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("shard",))


def _fields_equal(got, ref):
    for f, g, r in zip(ref._fields, got, ref):
        if r is not None:
            assert np.array_equal(g.numpy(), np.asarray(r)), f


def test_partition_matches_jax():
    prob, _ = synth_problem(jax.random.PRNGKey(1))
    _fields_equal(td.partition_problem(_t(prob), 8), jd.partition_problem(prob, 8))


def test_partition_of_an_overflowing_shard_matches_jax():
    """Shard 0 owns half of the observations (1024 of its 256 slots), some
    rows are invalid: the kept rows, the order, the fills and the last slot
    (written last by a dropped row: fill, T13) equal JAX's."""
    prob, _ = synth_problem(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    O = prob.obs_pt.shape[0]
    pt = np.asarray(prob.obs_pt).copy()
    pt[: O // 2] = rng.integers(0, 32, O // 2)
    valid = rng.random(O) > 0.1
    prob = prob._replace(obs_pt=jnp.asarray(pt, jnp.int32), obs_valid=jnp.asarray(valid))
    ref = jd.partition_problem(prob, 8)
    got = td.partition_problem(_t(prob), 8)
    _fields_equal(got, ref)
    obs_per = O // 8
    assert int(np.asarray(ref.obs_valid[:obs_per]).sum()) == obs_per - 1   # the last slot lost
    assert not bool(ref.obs_valid[obs_per - 1])


@pytest.fixture(scope="module")
def modes():
    """JAX's and the port's solves of test_comm_modes_agree's problem."""
    prob, gt = synth_problem(jax.random.PRNGKey(2), n_cams=8)
    pj = jd.partition_problem(prob, 8)
    pt = td.partition_problem(_t(prob), 8)
    out = {}
    for comm in ("matvec", "dense", "camshard"):
        ref = jd.dist_bundle_adjust(pj, _jmesh(), cam_model="pinhole", cam_params=K_EUROC,
                                    iterations=10, comm=comm)
        mesh = multihost.Mesh(8)
        got = td.dist_bundle_adjust(pt, mesh, cam_model="pinhole", cam_params=CAM,
                                    iterations=10, comm=comm)
        out[comm] = (got, ref, mesh.n_collectives)
    return out, gt


@pytest.mark.parametrize("comm", ["matvec", "dense", "camshard"])
def test_dist_bundle_adjust_matches_jax(modes, comm):
    out, (R_gt, t_gt, X_gt) = modes
    (R, t, X, cost), (Rj, tj, Xj, cj), n_coll = out[comm]
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-4)
    assert abs(float(cost) - float(cj)) <= 1e-3 * max(float(cj), 1e-3)
    # JAX's gates: exact observations recover the truth, the modes agree
    assert float(np.linalg.norm(t.numpy() - np.asarray(t_gt), axis=-1).max()) < 5e-3
    assert float(np.linalg.norm(X.numpy() - np.asarray(X_gt), axis=-1).mean()) < 5e-3
    d = np.abs(t.numpy() - out["matvec"][0][1].numpy()).max()
    assert d < 2e-3, d
    # collectives per LM iteration (10), plus the points' all_gather
    per_iter = {"matvec": 32 + 6, "dense": 2, "camshard": 4 + 4 * 32}[comm]
    assert n_coll == 10 * per_iter + 1


def test_dense_assembly_with_repeated_pairs_matches_jax():
    """Every (camera, point) pair observed twice: the G scatter and the
    per-camera rv sums add both rows (T14), shard by shard as JAX's."""
    prob, _ = synth_problem(jax.random.PRNGKey(4), n_cams=6, n_pts=128, obs_cap=768)
    prob = prob._replace(**{f: jnp.concatenate([getattr(prob, f)] * 2)
                            for f in ("obs_cam", "obs_pt", "obs_uv", "obs_inv_sigma2",
                                      "obs_valid")})
    pj = jd.partition_problem(prob, 8)
    K, P_l, O_l = 6, 16, pj.obs_cam.shape[0] // 8
    lam = 1e-3
    Hpp_all, bp_all, C_all, S_ref, rv_ref = [], [], [], [], []
    for s in range(8):
        rows, pts = slice(s * O_l, (s + 1) * O_l), slice(s * P_l, (s + 1) * P_l)
        lo = jnp.clip(pj.obs_pt[rows] - s * P_l, 0, P_l - 1)
        sp = pj._replace(X=pj.X[pts], pt_valid=pj.pt_valid[pts], obs_cam=pj.obs_cam[rows],
                         obs_pt=lo, obs_uv=pj.obs_uv[rows],
                         obs_inv_sigma2=pj.obs_inv_sigma2[rows], obs_valid=pj.obs_valid[rows])
        Hcc, bc, Hpp, bp, C, _, _, _ = jba._build_normal_eq(sp, sp.R, sp.t, sp.X, "pinhole",
                                                            K_EUROC, 5.991, True)
        S_off, rv, _ = jd._dense_reduced_local(Hcc, bc, Hpp, bp, C, sp.obs_cam, lo, lam,
                                               sp.cam_fixed, sp.pt_valid)
        Hpp_all.append(Hpp), bp_all.append(bp), C_all.append(C)
        S_ref.append(S_off), rv_ref.append(rv)
    cat = lambda xs: torch.from_numpy(np.concatenate([np.asarray(x) for x in xs]))  # noqa: E731
    shard = torch.arange(8 * O_l) // O_l
    cam_row = shard * K + torch.from_numpy(np.array(pj.obs_cam)).long()
    lo_pt = shard * P_l + torch.clamp(torch.from_numpy(np.array(pj.obs_pt)).long()
                                      - shard * P_l, 0, P_l - 1)
    S_l, rv_l, _ = td._dense_reduced_local(cat(Hpp_all), cat(bp_all), cat(C_all), cam_row, lo_pt,
                                           lam, torch.ones(8 * P_l, dtype=torch.bool), 8, K)
    for s in range(8):
        scale = float(np.abs(np.asarray(S_ref[s])).max())
        np.testing.assert_allclose(S_l[s].numpy(), np.asarray(S_ref[s]), atol=1e-5 * scale)
        np.testing.assert_allclose(rv_l[s].numpy(), np.asarray(rv_ref[s]),
                                   atol=1e-5 * float(np.abs(np.asarray(rv_ref[s])).max()))


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from orbslam3_tpu_torch.ops import cameras, lie
from orbslam3_tpu_torch.parallel import dist_ba, multihost
from orbslam3_tpu_torch.solver import ba
multihost.initialize_from_env()
mesh = multihost.global_mesh(local=int(os.environ["SLAM_LOCAL"]))
assert mesh.size == 4, mesh.size
K4 = torch.tensor([458.654, 457.296, 367.215, 248.375])
C, P, O = 6, 256, 1024
rng = np.random.default_rng(0)
f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
X = f32(rng.normal(0, 1, (P, 3)) * [2, 2, 1] + [0, 0, 8])
R = torch.eye(3).expand(C, 3, 3).contiguous()
t = f32(np.stack([np.linspace(0, 1, C), np.zeros(C), np.zeros(C)], 1))
obs_cam = torch.from_numpy(rng.integers(0, C, O).astype(np.int32))
obs_pt = torch.from_numpy((np.arange(O) % P).astype(np.int32))
uv = cameras.pinhole_project(K4, lie.se3_apply(R[obs_cam.long()], t[obs_cam.long()], X[obs_pt.long()]))
uv = uv + f32(rng.normal(0, 0.5, (O, 2)))
prob = ba.BAProblem(
    R=R, t=t, cam_fixed=torch.arange(C) == 0, cam_valid=torch.ones(C, dtype=torch.bool),
    X=X + f32(rng.normal(0, 0.02, (P, 3))), pt_valid=torch.ones(P, dtype=torch.bool),
    obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv, obs_inv_sigma2=torch.ones(O),
    obs_valid=torch.ones(O, dtype=torch.bool))
R2, t2, X2, cost = dist_ba.dist_bundle_adjust(
    dist_ba.partition_problem(prob, mesh.size), mesh, cam_model="pinhole", cam_params=K4,
    iterations=4)
if multihost.is_primary():
    open(os.environ["SLAM_OUT"], "w").write(json.dumps({"t": t2.tolist(), "cost": float(cost)}))
"""


def test_two_process_matches_single_process(tmp_path):
    """2 gloo processes x 2 local shards against 1 process x 4 shards on
    test_multihost's problem (JAX's bounds: translations within 5e-2,
    costs within 20%, both near the truth)."""
    results = {}
    for n_proc, local in ((1, 4), (2, 2)):
        out_path = str(tmp_path / f"out_{n_proc}.json")
        procs = []
        for pid in range(n_proc):
            env = dict(os.environ, SLAM_OUT=out_path, SLAM_LOCAL=str(local),
                       SLAM_NUM_PROCESSES=str(n_proc), SLAM_PROCESS_ID=str(pid),
                       SLAM_COORDINATOR="file://" + str(tmp_path / f"rdv_{n_proc}"),
                       PYTHONPATH=REPO, OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env,
                                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                          text=True))
        try:
            errs = [p.communicate(timeout=120)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, e in zip(procs, errs):
            assert p.returncode == 0, e[-2000:]
        results[n_proc] = json.load(open(out_path))
    t1, t2 = np.asarray(results[1]["t"]), np.asarray(results[2]["t"])
    assert np.isfinite(t1).all() and np.isfinite(t2).all()
    assert np.abs(t1 - t2).max() < 5e-2, np.abs(t1 - t2).max()
    for t in (t1, t2):
        assert np.abs(t[:, 0] - np.linspace(0, 1, 6)).max() < 0.1
    assert abs(results[1]["cost"] - results[2]["cost"]) < 0.2 * max(results[1]["cost"], 1.0)
