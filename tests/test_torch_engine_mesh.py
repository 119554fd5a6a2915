"""The engine's sharded local BA: the port's `system.local_ba` with
`ba_mesh_shards > 1` against the JAX System's `_local_ba` on its 8-device
virtual CPU mesh, and the port's counterpart of `tests/test_engine_mesh.py`.

On `test_torch_mapping`'s JAX-built keyframe map both window BAs run the COO
bank gather, `partition_problem` and the sharded solver: poses within 1e-4,
points within 1e-3 of their scale (the tolerances of that file's
`test_run_local_ba_matches_jax`), with caps that need rounding up to the
shard count (where no shard of JAX's overflows).  The cap rounding itself
against JAX's (16, 4100, 12300) -> (16, 4104, 12304).  Two deliberate
differences: where JAX's shards overflow and drop observations, the port's
do not (it deals the window's points over the shards first); with more
shards than JAX has devices, JAX solves on one device (its grid solver),
the port shards anyway.  The two whole-System cases of JAX's `TestEngineMesh` run the port
alone with JAX's gates (`utils/engine_mesh.py`) and are slow, as JAX's are.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from jax.sharding import Mesh as JMesh

from orbslam3_tpu.parallel import dist_ba as jdist
from orbslam3_tpu.pipeline import mapping as jmapping
from orbslam3_tpu.pipeline import system as jsystem
from orbslam3_tpu_torch.features.extractor import OrbParams
from orbslam3_tpu_torch.parallel import dist_ba, multihost
from orbslam3_tpu_torch.pipeline import mapping as tmapping
from orbslam3_tpu_torch.pipeline import system as tsystem
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.utils import engine_mesh
from test_torch_mapping import HW, K4, _kf_map, _perturbed

torch.set_num_threads(2)


def _configs(**kw):
    cfg = tsystem.SlamConfig(cam_params=tuple(float(x) for x in K4), image_hw=HW,
                             orb=OrbParams(n_levels=4), enable_relocalization=False, **kw)
    return cfg, H.jax_config(cfg)


class _Caps(Exception):
    pass


def _spied_caps(monkeypatch, cfg, jcfg, m, bank):
    """The (cap_cams, cap_pts, cap_obs) and the mesh each package's window
    BA hands `run_local_ba` (the spies stop the call)."""
    seen = {}

    def spy(name):
        def run(*a, mesh=None, cap_cams=None, cap_pts=None, cap_obs=None, **kw):
            seen[name] = ((cap_cams, cap_pts, cap_obs), mesh)
            raise _Caps
        return run

    monkeypatch.setattr(jmapping, "run_local_ba", spy("jax"))
    monkeypatch.setattr(tmapping, "run_local_ba", spy("port"))
    mj, bj, mt, bt = m + bank
    for call in (lambda: jsystem.System(jcfg)._local_ba(mj, jnp.asarray(5), bj),
                 lambda: tsystem.local_ba(cfg, torch.from_numpy(K4), mt, 5, bt)):
        with pytest.raises(_Caps):
            call()
    return seen


@pytest.fixture(scope="module")
def kf_map():
    mj, bj, _, _ = _kf_map(8)
    mj = _perturbed(mj, 9)
    return (mj, convert.map_from_numpy(H.fields(mj))), (bj, convert.bank_from_numpy(H.fields(bj)))


def test_sharded_local_ba_matches_jax(kf_map):
    """ba_caps (8, 252, 2044) at 8 shards: both round them to (8, 256, 2048)
    and solve over the mesh; the free cameras and the points agree."""
    (mj, mt), (bj, bt) = kf_map
    cfg, jcfg = _configs(ba_mesh_shards=8, ba_caps=(8, 252, 2044))
    ref = jsystem.System(jcfg)._local_ba(mj, jnp.asarray(5), bj)
    got = tsystem.local_ba(cfg, torch.from_numpy(K4), mt, 5, bt)
    np.testing.assert_allclose(got.kf_R.numpy(), np.asarray(ref.kf_R), atol=1e-4)
    np.testing.assert_allclose(got.kf_t.numpy(), np.asarray(ref.kf_t), atol=1e-4)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(ref.pt_xyz), atol=1e-3 * 8)
    assert np.abs(np.asarray(ref.kf_t) - np.asarray(mj.kf_t)).max() > 1e-3     # it moved


def test_sharded_window_keeps_the_observations_jax_drops(kf_map):
    """Deliberate difference.  The gather compacts the window's 159 points
    into the first slots; at 1024 observation slots over 8 shards JAX's
    partition leaves them in the first five shards, which overflow their
    128 slots and drop 197 of the 820 observations, so its solve moves with
    the slot count.  The port deals the points over the shards first: no
    row is dropped and its solve at 1024 slots is the one at 2048 (within
    float rounding), where JAX drops nothing either."""
    (mj, mt), (bj, bt) = kf_map
    jprob = jmapping.gather_window_problem_bank(mj, bj, jnp.asarray(5), 8, 4, 1.2, cap_cams=8,
                                                cap_pts=256, cap_obs=1024)[0]
    kept = int(jdist.partition_problem(jprob, 8).obs_valid.sum())
    assert (int(jprob.obs_valid.sum()), kept) == (820, 623)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("shard",))
    kw = dict(window=8, iterations=6, scale_factor=1.2, n_levels=4, cap_cams=8, cap_pts=256)
    ref = {c: jmapping.run_local_ba(mj, jnp.asarray(5), "pinhole", K4, bank=bj, mesh=jmesh,
                                    cap_obs=c, **kw) for c in (1024, 2048)}
    parts = []
    solve = dist_ba.partition_problem

    def spy(prob, n):
        out = solve(prob, n)
        parts.append((int(prob.obs_valid.sum()), int(out.obs_valid.sum())))
        return out

    dist_ba.partition_problem = spy
    try:
        got = {c: tmapping.run_local_ba(mt, 5, "pinhole", torch.from_numpy(K4), bank=bt,
                                        mesh=multihost.Mesh(8), cap_obs=c, **kw)
               for c in (1024, 2048)}
    finally:
        dist_ba.partition_problem = solve
    assert parts == [(820, 820), (820, 820)]
    d_port = float((got[1024].kf_t - got[2048].kf_t).abs().max())
    d_jax = float(np.abs(np.asarray(ref[1024].kf_t) - np.asarray(ref[2048].kf_t)).max())
    assert d_port < 1e-5 < 1e-3 < d_jax, (d_port, d_jax)
    np.testing.assert_allclose(got[2048].kf_t.numpy(), np.asarray(ref[2048].kf_t), atol=1e-4)


def test_caps_round_up_to_the_shard_count_as_jax(kf_map, monkeypatch):
    (mj, mt), (bj, bt) = kf_map
    cfg, jcfg = _configs(ba_mesh_shards=8, ba_caps=(16, 4100, 12300))
    seen = _spied_caps(monkeypatch, cfg, jcfg, (mj, bj), (mt, bt))
    assert seen["jax"][0] == seen["port"][0] == (16, 4104, 12304)
    assert seen["jax"][1].devices.size == seen["port"][1].size == 8


def test_more_shards_than_devices_shard_on_one_device(kf_map, monkeypatch):
    """Deliberate difference: 16 shards on JAX's 8 devices give no mesh (the
    window goes to its one-device grid solver, caps as given); the port puts
    16 shards on its one device, caps rounded."""
    (mj, mt), (bj, bt) = kf_map
    cfg, jcfg = _configs(ba_mesh_shards=16, ba_caps=(8, 252, 2044))
    seen = _spied_caps(monkeypatch, cfg, jcfg, (mj, bj), (mt, bt))
    assert seen["jax"] == ((8, 252, 2044), None)
    assert seen["port"][0] == (8, 256, 2048) and seen["port"][1].size == 16
    monkeypatch.undo()
    calls = []
    solve = dist_ba.dist_bundle_adjust
    monkeypatch.setattr(dist_ba, "dist_bundle_adjust",
                        lambda *a, **kw: calls.append(a[1].size) or solve(*a, **kw))
    got = tsystem.local_ba(cfg, torch.from_numpy(K4), mt, 5, bt)
    assert calls == [16] and bool(torch.isfinite(got.kf_t).all())
    assert (got.kf_t - mt.kf_t).abs().max() > 1e-3


@pytest.mark.slow
class TestEngineMesh:
    def test_full_system_sharded_matches_single_device(self):
        one = engine_mesh.run(engine_mesh.config(), "cpu", coo=True)
        sharded = engine_mesh.run(engine_mesh.config(ba_mesh_shards=8), "cpu")
        assert not engine_mesh.gates(one, sharded)

    def test_indivisible_caps_are_rounded_not_fatal(self):
        cfg = dataclasses.replace(engine_mesh.config(ba_mesh_shards=8), ba_caps=(16, 4100, 12300))
        _, rmse, _ = engine_mesh.run(cfg, "cpu", n_frames=30, seed=7)
        assert rmse < 0.05, rmse
