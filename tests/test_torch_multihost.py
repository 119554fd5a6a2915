"""The port's multi-process layer and its tools: `parallel/multihost.py`
with no SLAM_* variables, `graft_entry.dryrun_multichip` at 1, 2 and 4
shards (the counterpart of `__graft_entry__.dryrun_multichip`) and
`graft_entry.entry`, and `tools/bench_multihost.py` at a tiny size: the JAX
tool's JSON keys, in-process (`--local-devices`) and across two gloo
processes, and its refusal without a card."""

import pytest
import torch

from orbslam3_tpu_torch import graft_entry
from orbslam3_tpu_torch.parallel import multihost
from orbslam3_tpu_torch.tools import bench_multihost

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--cams", "6", "--pts-per-shard", "64", "--obs-per-shard", "256",
        "--iters", "2", "--comm", "matvec"]
WORKER_KEYS = {"n_processes", "n_shards", "obs_total", "comm", "ms_per_lm_iter"}


def test_multihost_without_slam_variables(monkeypatch):
    for k in ("SLAM_NUM_PROCESSES", "SLAM_PROCESS_ID", "SLAM_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_from_env() == 0
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary()
    mesh = multihost.global_mesh(local=3)
    assert (mesh.size, mesh.world, mesh.rank, mesh.shape) == (3, 1, 0, {"shard": 3})
    x = torch.arange(12.0).reshape(3, 2, 2)
    assert torch.equal(mesh.psum(x), x.sum(0))
    assert torch.equal(mesh.all_gather(x), x.reshape(6, 2))
    assert mesh.n_collectives == 2
    assert multihost.backend_for(2) == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip(n):
    graft_entry.dryrun_multichip(n, device="cpu")


def test_entry_runs_one_frame():
    fn, args = graft_entry.entry(device="cpu")
    R, t, n_inl = fn(*args)
    assert R.shape == (3, 3) and t.shape == (3,) and int(n_inl) == 0   # an empty map


def test_bench_local_devices_prints_the_jax_keys(capfd, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    line = bench_multihost.main(TINY + ["--local-devices", "--dev-per-proc", "2"])
    assert set(line) == {"mode", "n_devices", "pinned", "ms_per_iter_1dev", "ms_per_iter_ndev",
                         "weak_scaling_efficiency", "detail"}
    assert line["mode"] == "weak_scaling_local_devices_constant_work_per_shard"
    for n, d in line["detail"].items():
        assert WORKER_KEYS <= set(d) and d["n_shards"] == n and d["n_processes"] == 1
        assert d["collectives_per_lm_iter"] == 32 + 6
    assert '"weak_scaling_efficiency"' in capfd.readouterr().out


def test_bench_two_processes_prints_the_jax_keys(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    line = bench_multihost.main(TINY + ["--procs", "2", "--dev-per-proc", "2"])
    assert set(line) == {"mode", "procs", "dev_per_proc", "pinned", "ms_per_iter_1proc",
                         "ms_per_iter_nproc", "weak_scaling_efficiency", "detail"}
    d = line["detail"][2]
    assert WORKER_KEYS <= set(d) and (d["n_processes"], d["n_shards"]) == (2, 4)
    assert d["backend"] == "gloo"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_bench_refuses_the_card_without_one():
    with pytest.raises(SystemExit):
        bench_multihost.main(["--local-devices"])
