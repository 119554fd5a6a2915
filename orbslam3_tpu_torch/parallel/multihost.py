"""Multi-process distribution for the BA back-end, and the port's mesh.

Counterpart of `orbslam3_tpu/parallel/multihost.py`.  JAX builds one mesh
over every device of every process and lets `lax.psum` reduce over it.  The
port's `Mesh` is 1-D and has two levels:

  * `local` shards held by this process, all on the device of the tensors
    given to it (one card cannot hold two NCCL ranks, so the shards of one
    card live in one process; this is also the form the engine uses);
  * an optional `torch.distributed` group of `world` processes (one per
    host or card, torch's own idiom).

`size = world * local`, and shard `rank * local + i` is this process's i-th.
`psum` sums the local shards' partials, then all-reduces them across the
group; `all_gather` concatenates every shard's rows in shard order.

Environment contract (torchrun-style, one process per host), as in JAX:
  SLAM_COORDINATOR   host:port of process 0   (default 127.0.0.1:29500);
                     a value with a scheme ("file://...", "tcp://...") is
                     used as the rendezvous as it stands
  SLAM_NUM_PROCESSES total process count       (default 1)
  SLAM_PROCESS_ID    this process's rank       (default 0)

Weak-scaling bench: `orbslam3_tpu_torch/tools/bench_multihost.py`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

RENDEZVOUS_TIMEOUT_S = 120


class Mesh:
    """A 1-D mesh of `local` in-process shards times the processes of
    `group` (None: this process alone).  `n_collectives` counts the psums
    and all-gathers made through it."""

    def __init__(self, local: int = 1, group=None, axis: str = "shard"):
        assert local >= 1, local
        self.local = local
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.size = self.world * local
        self.shape = {axis: self.size}
        self.n_collectives = 0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(local, ...) per-shard partials -> (...) their sum over the mesh,
        the same on every shard."""
        self.n_collectives += 1
        y = x.sum(0)
        if self.group is not None:
            dist.all_reduce(y, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(local, n, ...) shard rows -> (size * n, ...) in shard order.
        Across processes it is an all-reduce of each process's rows placed
        in a zero buffer (exact: every entry is one value plus zeros),
        which every backend takes for tensors on a card; gloo's all_gather
        takes CPU tensors only."""
        self.n_collectives += 1
        rows = x.reshape((-1,) + x.shape[2:])
        if self.group is None:
            return rows
        buf = torch.zeros((self.world,) + rows.shape, dtype=rows.dtype, device=rows.device)
        buf[self.rank] = rows
        dist.all_reduce(buf, group=self.group)
        return buf.reshape((-1,) + rows.shape[1:])


def backend_for(n_processes: int) -> str:
    """NCCL when each process has a card of its own, else gloo (on the CPU,
    or when the processes share one card: NCCL refuses two ranks on one
    GPU).  The tensors stay where they are either way."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= n_processes:
        return "nccl"
    return "gloo"


def initialize_from_env() -> int:
    """`init_process_group` from the SLAM_* variables.  Returns the process
    id; with one process (the default) it initializes nothing and returns
    0.  Under NCCL the process takes the card of its rank."""
    n = int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    if n <= 1:
        return 0
    pid = int(os.environ.get("SLAM_PROCESS_ID", "0"))
    coord = os.environ.get("SLAM_COORDINATOR", "127.0.0.1:29500")
    backend = backend_for(n)
    if backend == "nccl":
        torch.cuda.set_device(pid)
    print(f"multihost: process {pid} of {n}, backend {backend}", flush=True)
    dist.init_process_group(
        backend, init_method=coord if "://" in coord else f"tcp://{coord}",
        world_size=n, rank=pid, timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return pid


def global_mesh(axis: str = "shard", local: int = 1) -> Mesh:
    """One 1-D mesh over `local` shards of every process of the default
    group (this process alone when none is initialized).  JAX's mesh spans
    the devices that exist; torch has no virtual devices, so the shards per
    process are an argument."""
    return Mesh(local, dist.group.WORLD if dist.is_initialized() else None, axis)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
