"""Multi-process weak-scaling benchmark for the distributed Schur BA.

    python -m orbslam3_tpu_torch.tools.bench_multihost [--procs 2]
        [--dev-per-proc 4] [--obs-per-shard 8192] [--iters 4]
        [--comm dense|camshard|matvec] [--probe] [--local-devices]
        [--pin-cores] [--device cuda|cpu]

The port of `tools/bench_multihost.py`, with its modes, arguments, defaults
(32 cameras, 2,048 points and 8,192 observations per shard, 4 LM
iterations, `--comm dense`) and JSON lines.  CONSTANT WORK PER SHARD: every
shard owns the same number of points and observations, so perfect scaling
keeps the per-LM-iteration time flat as processes are added (efficiency =
t_1proc / t_Nproc, ideal 1.0).

Modes:
  launcher (default): spawns 1 and then N worker processes on this machine
    and prints one JSON line.
  --worker (SLAM_NUM_PROCESSES set): `multihost.initialize_from_env`, the
    global mesh, the engine's `dist_ba`; rank 0 prints its timing.
  --probe: a dependent chain of bare psums of the reduced-system payload
    ((C, 6) float32, what every PCG matvec reduces) instead of the BA.
  --local-devices: one process, 1 against N local shards.

Where the JAX tool gives each process N virtual CPU devices
(`--xla_force_host_platform_device_count`), the port gives it N local shards
(`--dev-per-proc`) on its device: the first card (`--device`, default; the
tool refuses to run without one) or the CPU.  Processes that share a card
reduce through gloo, processes with a card each through NCCL
(`multihost.backend_for`); the workers rendezvous through a file in a
fresh temporary directory.  Besides JAX's keys, a worker's line carries
its device, backend, the collectives per LM iteration, the final
translations and cost.

CAVEAT on local numbers (the JAX tool's): the processes of this launcher
share one machine, its cores and here its one card, so adding a process
oversubscribes compute and the measured efficiency bounds the HARNESS, not
the algorithm.  The number that matters must come from real multi-host
hardware; this tool is the ready-to-run methodology (constant work per
shard, collectives across processes).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import add_device_arg, device_of

K4 = (458.654, 457.296, 367.215, 248.375)


def _problem(args, n_shards: int, dev):
    """bench_multihost's problem: the same NumPy draws in the same order."""
    import torch

    from ..ops import cameras, lie
    from ..solver import ba

    cam = torch.tensor(K4, dtype=torch.float32, device=dev)
    C = args.cams
    P = args.pts_per_shard * n_shards
    O = args.obs_per_shard * n_shards
    rng = np.random.default_rng(0)
    on = lambda a, dt=np.float32: torch.from_numpy(np.asarray(a, dt)).to(dev)  # noqa: E731
    X = on(rng.normal(0, 1, (P, 3)) * [2, 2, 1] + [0, 0, 8])
    R = torch.eye(3, device=dev).expand(C, 3, 3).contiguous()
    t = on(np.stack([np.linspace(0, 2, C), np.zeros(C), np.zeros(C)], 1))
    obs_cam = on(rng.integers(0, C, O), np.int32)
    obs_pt = on(np.arange(O) % P, np.int32)
    uv = cameras.pinhole_project(cam, lie.se3_apply(R[obs_cam.long()], t[obs_cam.long()],
                                                    X[obs_pt.long()]))
    uv = uv + on(rng.normal(0, 0.5, (O, 2)))
    prob = ba.BAProblem(
        R=R, t=t, cam_fixed=torch.arange(C, device=dev) == 0,
        cam_valid=torch.ones(C, dtype=torch.bool, device=dev),
        X=X + on(rng.normal(0, 0.02, (P, 3))),
        pt_valid=torch.ones(P, dtype=torch.bool, device=dev),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv,
        obs_inv_sigma2=torch.ones(O, device=dev),
        obs_valid=torch.ones(O, dtype=torch.bool, device=dev))
    return prob, cam


def _worker_device(ap, args):
    import torch

    dev = device_of(ap, args.device)
    if dev.type == "cuda" and args.device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def worker(ap, args):
    import torch
    import torch.distributed as dist

    from ..parallel import dist_ba, multihost

    multihost.initialize_from_env()
    dev = _worker_device(ap, args)
    mesh = multihost.global_mesh(local=args.dev_per_proc)
    prob, cam = _problem(args, mesh.size, dev)
    dprob = dist_ba.partition_problem(prob, mesh.size)

    def run():
        return dist_ba.dist_bundle_adjust(dprob, mesh, cam_model="pinhole", cam_params=cam,
                                          iterations=args.iters, comm=args.comm)

    run()                                   # warm-up
    _sync(dev)
    n0 = mesh.n_collectives
    t0 = time.perf_counter()
    for _ in range(3):
        out = run()
    _sync(dev)
    dt = (time.perf_counter() - t0) / (3 * args.iters)
    # one all_gather of the points per solve, outside the LM loop
    per_iter = ((mesh.n_collectives - n0) / 3 - 1) / args.iters
    if multihost.is_primary():
        print(json.dumps({
            "n_processes": mesh.world,
            "n_shards": mesh.size,
            "obs_total": args.obs_per_shard * mesh.size,
            "comm": args.comm,
            "ms_per_lm_iter": round(dt * 1000, 2),
            "device": str(dev),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "collectives_per_lm_iter": per_iter,
            "t": out[1].cpu().tolist(),
            "cost": float(out[3]),
        }), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def probe_worker(ap, args):
    """Bare-collective latency: a dependent chain of psums of the (C, 6)
    payload over the global mesh (the collective term of t_N = t_1 +
    n_collectives * t_psum)."""
    import torch
    import torch.distributed as dist

    from ..parallel import multihost

    multihost.initialize_from_env()
    dev = _worker_device(ap, args)
    mesh = multihost.global_mesh(local=args.dev_per_proc)
    L = mesh.local

    def chain(v):
        for _ in range(10):
            v = mesh.psum((v * 0.5).expand((L,) + v.shape))
        return v

    x = torch.ones((args.cams, 6), device=dev)
    chain(x)
    _sync(dev)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        x = chain(x)
    _sync(dev)
    per_psum = (time.perf_counter() - t0) / (reps * 10)
    if multihost.is_primary():
        print(json.dumps({"psum_ms": round(per_psum * 1000, 3),
                          "n_processes": mesh.world}), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def _spawn(args, n_proc: int, dev_per_proc: int, probe: bool = False, cores=None):
    """Start n_proc workers with dev_per_proc local shards each; returns
    rank 0's JSON line."""
    rdv = tempfile.mkdtemp(prefix="slam_rdv_")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(n_proc):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in [env.get("PYTHONPATH")] if p])
        env["SLAM_NUM_PROCESSES"] = str(n_proc)
        env["SLAM_PROCESS_ID"] = str(pid)
        env["SLAM_COORDINATOR"] = "file://" + os.path.join(rdv, "store")
        cmd = [sys.executable, "-m", __spec__.name, "--worker",
               "--dev-per-proc", str(dev_per_proc)] + _forward_args(args)
        if probe:
            cmd.append("--probe")
        if cores is not None:
            cmd = ["taskset", "-c", ",".join(str(c) for c in cores(pid))] + cmd
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(rdv, ignore_errors=True)
    bad = [(p.returncode, o[1][-2000:]) for p, o in zip(procs, outs) if p.returncode != 0]
    assert not bad, f"worker failed at n_proc={n_proc}: {bad}"
    return json.loads(next(l for l in outs[0][0].splitlines() if l.startswith("{")))


def launch_local_devices(args):
    """Algorithm-side weak scaling with in-process collectives: one process,
    1 against N local shards, constant work per shard, each run pinned to as
    many cores as it has shards with `--pin-cores`."""
    results = {}
    for n_dev in (1, args.dev_per_proc):
        cores = (lambda pid, n=n_dev: range(n)) if args.pin_cores else None
        results[n_dev] = _spawn(args, 1, n_dev, cores=cores)
    t1 = results[1]["ms_per_lm_iter"]
    tn = results[args.dev_per_proc]["ms_per_lm_iter"]
    line = {
        "mode": "weak_scaling_local_devices_constant_work_per_shard",
        "n_devices": args.dev_per_proc,
        "pinned": bool(args.pin_cores),
        "ms_per_iter_1dev": t1,
        "ms_per_iter_ndev": tn,
        "weak_scaling_efficiency": round(t1 / tn, 3),
        "detail": results,
    }
    print(json.dumps(line), flush=True)
    return line


def launch(args):
    results = {}
    span = args.dev_per_proc
    cores = (lambda pid: range(pid * span, (pid + 1) * span)) if args.pin_cores else None
    for n_proc in (1, args.procs):
        results[n_proc] = _spawn(args, n_proc, args.dev_per_proc, args.probe, cores)
    if args.probe:
        line = {
            "mode": "bare_psum_latency",
            "procs": args.procs,
            "pinned": bool(args.pin_cores),
            "psum_ms_1proc": results[1]["psum_ms"],
            "psum_ms_nproc": results[args.procs]["psum_ms"],
        }
    else:
        t1 = results[1]["ms_per_lm_iter"]
        tn = results[args.procs]["ms_per_lm_iter"]
        line = {
            "mode": "weak_scaling_constant_work_per_shard",
            "procs": args.procs,
            "dev_per_proc": args.dev_per_proc,
            "pinned": bool(args.pin_cores),
            "ms_per_iter_1proc": t1,
            "ms_per_iter_nproc": tn,
            "weak_scaling_efficiency": round(t1 / tn, 3),
            "detail": results,
        }
    print(json.dumps(line), flush=True)
    return line


def _forward_args(args):
    return ["--cams", str(args.cams),
            "--pts-per-shard", str(args.pts_per_shard),
            "--obs-per-shard", str(args.obs_per_shard),
            "--iters", str(args.iters),
            "--comm", args.comm,
            "--device", args.device]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.bench_multihost")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--dev-per-proc", type=int, default=4,
                    help="local shards per process, on the process's device")
    ap.add_argument("--cams", type=int, default=32)
    ap.add_argument("--pts-per-shard", type=int, default=2048)
    ap.add_argument("--obs-per-shard", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--comm", default="dense",
                    choices=("dense", "camshard", "matvec"),
                    help="collective scheme: dense = 2 collectives/LM "
                         "iter (the cross-process default); matvec = a psum "
                         "per PCG matvec; camshard = KF-block-sharded rows")
    ap.add_argument("--pin-cores", action="store_true",
                    help="taskset each worker to its own core span "
                         "(procs * dev_per_proc must be <= nproc)")
    ap.add_argument("--probe", action="store_true",
                    help="measure bare psum latency instead of BA")
    ap.add_argument("--local-devices", action="store_true",
                    help="1-process 1-vs-N-shard weak scaling "
                         "(in-process collectives)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.worker:
        if args.probe:
            probe_worker(ap, args)
        else:
            worker(ap, args)
        return None
    device_of(ap, args.device)       # refuse a card that is not there
    if args.local_devices:
        return launch_local_devices(args)
    return launch(args)


if __name__ == "__main__":
    main()
