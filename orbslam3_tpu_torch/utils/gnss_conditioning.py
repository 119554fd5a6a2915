"""How well the first GNSS BA of `chip_smoke.py`'s phase 10b repeats, on one
device and against the CPU.

    python -m orbslam3_tpu_torch.utils.gnss_conditioning [--runs 10] [--cpu]

Drives `atlas_scene.drive_gnss` on the card (`--cpu`: on the CPU), keeps the
inputs of its first GNSS BA (`system.gnss_ba`), and prints, as fractions of
the map's extent (the largest |coordinate| of the BA's valid points), the
largest keyframe-centre difference of:

  * the drive's BA and `--runs` reruns from the same inputs against the same
    BA on the CPU (on the card: also three reruns under
    `torch.use_deterministic_algorithms`);
  * the CPU's BA of the points moved by 1e-7 (three seeds) against the
    unmoved one: what float32 rounding alone can move;
  * the BA's own movement of the centres;

and the LM step that the BA first accepts (the BA run with 1, 2, ...
iterations: the first count whose result moved).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import torch

from ..pipeline import system
from . import atlas_scene
from . import seeded_scene as scene


def _cpu(x):
    return type(x)(*(y.cpu() for y in x))


def measure(dev, runs: int = 10) -> dict:
    cfg = dataclasses.replace(scene.SceneConfig(), seed_frames=(), track_frames=tuple(range(78)))
    seen = {}
    run = system.gnss_ba

    def spy(*a, **kw):
        out = run(*a, **kw)
        seen.setdefault("first", (a, out))
        return out

    system.gnss_ba = spy
    try:
        atlas_scene.drive_gnss(cfg, scene.render_frames(cfg), dev)
    finally:
        system.gnss_ba = run
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    a, out = seen["first"]
    cfg_, cam, m, ki, pp, pw, bank = a
    cpu_args = (cfg_, cam.cpu(), _cpu(m), ki, pp.cpu(), pw.cpu(), _cpu(bank))
    ref = run(*cpu_args)
    nk = int(m.n_kf)
    ext = float(ref.pt_xyz[ref.pt_valid].abs().max())

    def centres(mm):
        return (-mm.kf_R[:nk].transpose(1, 2) @ mm.kf_t[:nk, :, None])[..., 0].cpu()

    def gap(mm, to=ref):
        return float((centres(mm) - centres(to)).abs().max()) / ext

    res = dict(extent=ext, n_kf=nk, drive=gap(out), reruns=[], deterministic=[])
    for _ in range(runs):
        o = run(*a)
        sync()
        res["reruns"].append(gap(o))
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)
        try:
            for _ in range(3):
                o = run(*a)
                sync()
                res["deterministic"].append(gap(o))
        finally:
            torch.use_deterministic_algorithms(False)
    res["perturbed_1e-7"] = []
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        m2 = cpu_args[2]._replace(pt_xyz=cpu_args[2].pt_xyz +
                                  1e-7 * torch.randn(m.pt_xyz.shape, generator=g))
        res["perturbed_1e-7"].append(gap(run(cpu_args[0], cpu_args[1], m2, *cpu_args[3:])))
    res["moved"] = gap(ref, cpu_args[2])
    iters = cfg_.local_ba_iters
    first = None
    for k in range(1, iters + 1):
        o = run(dataclasses.replace(cfg_, local_ba_iters=k), *cpu_args[1:])
        if gap(o, cpu_args[2]) > 0:
            first = k
            break
    res["first_accepted_step"] = first
    res["iterations"] = iters
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        dev, card = torch.device("cpu"), "the CPU"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA device (or --cpu)")
        dev = torch.device("cuda", 0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    r = measure(dev, args.runs)
    print(f"device: {card}")
    print(f"first GNSS BA: {r['n_kf']} keyframes, extent {r['extent']:.5g}; keyframe-centre "
          f"gaps as fractions of the extent:")
    print(f"  the drive's BA against the CPU's: {r['drive']:.4g}")
    print(f"  {len(r['reruns'])} reruns against the CPU's: {min(r['reruns']):.4g} - "
          f"{max(r['reruns']):.4g}")
    if r["deterministic"]:
        print(f"  deterministic algorithms: {r['deterministic']}")
    print(f"  the CPU's, points moved by 1e-7 (3 seeds): {r['perturbed_1e-7']}")
    print(f"  the BA's own movement: {r['moved']:.4g}")
    print(f"  first accepted LM step: {r['first_accepted_step']} of {r['iterations']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
