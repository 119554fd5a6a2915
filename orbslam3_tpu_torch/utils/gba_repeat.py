"""How the post-loop GBA of `chip_smoke.py`'s phase 9b repeats, and which
points leave its gate.

    python -m orbslam3_tpu_torch.utils.gba_repeat [--runs 20] [--closures 0] [--cpu]

Closes the loop of `utils/loop_scene.py` at the default capacity on the card
(`--cpu`: on the CPU) as phase 9b does, keeps the inputs the GBA reads
(`system.gba`), and runs the same GBA on the CPU from them as the reference,
with its LM history.  Then, from the same inputs:

  * `--runs` GBAs on the device with the solver's segment sums as they are
    (`solver/ba._seg_sum`: on a card a stable sort and `segment_reduce`) and
    as many with `index_add_` (on a card atomics, the sums before),
    interleaved; per run phase 9b's metrics
    against the CPU (points as a fraction of the map's extent, projections
    in pixels, keyframes 0 and the revisit), whether it equals the arm's
    first run bit for bit, its LM history (cost before and after each step,
    accepted or not), and its time by CUDA events;
  * the CPU's GBA of the problem with its observation rows in `--runs`
    random orders: what the summation order alone moves on one device.

For the point farthest from the CPU's in all of these it prints its
observations (keyframes), its parallax (the widest angle between the rays
of its observing keyframes), its depth in its first observer, and where
each run put it.  `--closures N` then runs `chip_smoke.closure_phase` N
times with each of the two sums, interleaved (from the repository's root),
and prints its gate's numbers per run and the failures of each.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..pipeline import system
from ..solver import ba
from . import loop_scene


def _cpu(x):
    return type(x)(*(None if y is None else y.cpu() for y in x))


def _on(x, dev):
    return type(x)(*(None if y is None else y.to(dev) for y in x))


def _atomic(n, idx, vals):
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx.long(), vals)


def inputs(dev):
    """(cfg, cam, map, keyframe, bank) the post-loop GBA reads after phase
    9b's closure on `dev`, on the CPU."""
    cfg = system.SlamConfig(cam_params=loop_scene.K4, image_hw=(480, 752),
                            enable_relocalization=False)
    s_ = system.System(cfg, device=dev)
    rv = loop_scene.build(s_, n_kp=1200)
    lc = loop_scene.loop_closer(s_, rv.kr)
    assert lc.try_close(s_, rv.ff, rv.kr, idx_fn=loop_scene.fixed_samples), "no closure"
    pend = s_._pending
    m_in, bank_in = (_cpu(x) for x in pend.inputs)
    return cfg, s_.cam_params.cpu(), m_in, rv.kr, bank_in


def run_gba(cfg, cam, m, kr, bank, seg_sum=None, order=None):
    """The GBA from these inputs; returns (map, LM history [(cost before,
    after, accepted)]).  `seg_sum` replaces the solver's segment sums;
    `order` permutes the problem's observation rows."""
    rec = {"cur": [], "new": []}
    build, cost, acc, solve = ba._build_normal_eq, ba._cost_only, ba._seg_sum, ba.bundle_adjust

    def build_(*a, **k):
        out = build(*a, **k)
        rec["cur"].append(out[5])
        return out

    def cost_(*a, **k):
        out = cost(*a, **k)
        rec["new"].append(out)
        return out

    def solve_(prob, *a, **k):
        if order is not None:
            o = order.to(prob.obs_cam.device)
            prob = prob._replace(**{f: getattr(prob, f)[o] for f in prob._fields
                                    if f.startswith("obs_") and getattr(prob, f) is not None})
        return solve(prob, *a, **k)

    ba._build_normal_eq, ba._cost_only, ba.bundle_adjust = build_, cost_, solve_
    if seg_sum is not None:
        ba._seg_sum = seg_sum
    try:
        out = system.gba(cfg, cam, m, kr, bank)
    finally:
        ba._build_normal_eq, ba._cost_only, ba.bundle_adjust, ba._seg_sum = \
            build, cost, solve, acc
    hist = [(float(c), float(n), bool(n < c)) for c, n in zip(rec["cur"], rec["new"])]
    return _cpu(out), hist


def metrics(got, ref, kr: int) -> dict:
    """Phase 9b's gate numbers of `got` against `ref` (both on the CPU)."""
    ok = ref.pt_valid
    uv_g, meas = loop_scene.reprojections(got)
    uv_r, meas_r = loop_scene.reprojections(ref)
    d = (got.pt_xyz - ref.pt_xyz).norm(dim=1) * ok
    return dict(
        pts=float((got.pt_xyz[ok] - ref.pt_xyz[ok]).abs().max() / ref.pt_xyz[ok].abs().max()),
        uv=float((uv_g - uv_r).abs().max()) if torch.equal(meas, meas_r) else float("inf"),
        pose=max(float((getattr(got, f)[k] - getattr(ref, f)[k]).abs().max())
                 for f in ("kf_R", "kf_t") for k in (0, kr)),
        worst=int(d.argmax()), worst_d=float(d.max()))


def point_report(m, p: int) -> dict:
    """The observations, parallax and depth of point p in map m."""
    K = m.kf_R.shape[0]
    sel = m.obs_valid & (m.obs_pt == p) & m.kf_valid[torch.clamp(m.obs_kf, 0, K - 1).long()]
    kfs = sorted(set(m.obs_kf[sel].tolist()))
    X = m.pt_xyz[p]
    rays = []
    for k in kfs:
        centre = -m.kf_R[k].T @ m.kf_t[k]
        r = X - centre
        rays.append(r / r.norm())
    par = 0.0
    for i in range(len(rays)):
        for j in range(i + 1, len(rays)):
            par = max(par, math.degrees(math.acos(float(torch.clamp(rays[i] @ rays[j], -1, 1)))))
    depth = float((m.kf_R[kfs[0]] @ X + m.kf_t[kfs[0]])[2]) if kfs else float("nan")
    return dict(point=p, observations=int(sel.sum()), keyframes=kfs, parallax_deg=par,
                depth=depth)


def _timed(dev, fn):
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def measure(dev, runs: int = 20) -> dict:
    cfg, cam, m_in, kr, bank_in = inputs(dev)
    ref, ref_hist = run_gba(cfg, cam, m_in, kr, bank_in)
    print(f"CPU GBA: LM {ref_hist}", flush=True)
    args_dev = (cfg, cam.to(dev), _on(m_in, dev), kr, _on(bank_in, dev))
    arms = {"sorted": None, "index_add_": _atomic}
    res = {k: [] for k in arms}
    first = {}
    for i in range(runs):
        for name in (list(arms) if i % 2 == 0 else list(arms)[::-1]):
            (out, hist), ms = _timed(dev, lambda: run_gba(*args_dev, seg_sum=arms[name]))
            met = metrics(out, ref, kr)
            same = name in first and all(torch.equal(a, b) for a, b in zip(out, first[name]))
            first.setdefault(name, out)
            met.update(ms=ms, bit_equal_to_first=same if i else None, hist=hist)
            res[name].append(met)
            print(f"{name} run {i}: points {met['pts']:.3e} of the extent, projections "
                  f"{met['uv']:.3e} px, poses {met['pose']:.3e}, worst point {met['worst']} "
                  f"moved {met['worst_d']:.4g}, bit-equal to the first {met['bit_equal_to_first']}, "
                  f"{ms:.2f} ms, accepted {[h[2] for h in hist]}", flush=True)
    perm = []
    g = torch.Generator().manual_seed(0)
    for i in range(runs):
        out, hist = run_gba(cfg, cam, m_in, kr, bank_in,
                            order=torch.randperm(cfg.map_capacity.n_obs, generator=g))
        met = metrics(out, ref, kr)
        met.update(hist=hist)
        perm.append(met)
        print(f"CPU, rows permuted {i}: points {met['pts']:.3e} of the extent, projections "
              f"{met['uv']:.3e} px, worst point {met['worst']} moved {met['worst_d']:.4g}, "
              f"accepted {[h[2] for h in hist]}", flush=True)
    every = [(r["pts"], r["worst"]) for arm in res.values() for r in arm] + \
        [(r["pts"], r["worst"]) for r in perm]
    worst = max(every)[1]
    rep = point_report(ref, worst)
    rep["cpu_xyz"] = ref.pt_xyz[worst].tolist()
    rep["input_xyz"] = m_in.pt_xyz[worst].tolist()
    print(f"worst point: {rep}", flush=True)
    for name in arms:
        pts = [r["pts"] for r in res[name]]
        print(f"{name}: {sum(p >= 1e-4 for p in pts)} of {len(pts)} runs past the gate (1e-4), "
              f"points {min(pts):.3e}-{max(pts):.3e}, median {np.median([r['ms'] for r in res[name]]):.2f} ms, "
              f"bit-equal runs {sum(bool(r['bit_equal_to_first']) for r in res[name][1:])} of "
              f"{len(pts) - 1}", flush=True)
    pts = [r["pts"] for r in perm]
    print(f"CPU, permuted rows: {sum(p >= 1e-4 for p in pts)} of {runs} past the gate, "
          f"points {min(pts):.3e}-{max(pts):.3e}", flush=True)
    return dict(ref_hist=ref_hist, arms=res, perm=perm, worst=rep)


def closures(n: int) -> dict:
    """`chip_smoke.closure_phase` n times on the card with the solver's sums
    as they are and n times with `index_add_`'s, interleaved; returns the
    failures of each."""
    import chip_smoke

    dev = torch.device("cuda", 0)
    bad = {"sorted": 0, "index_add_": 0}
    seg_sum = ba._seg_sum
    for i in range(2 * n):
        name = ("sorted", "index_add_")[(i + i // 2) % 2]
        ba._seg_sum = seg_sum if name == "sorted" else _atomic
        t0 = time.perf_counter()
        try:
            out = chip_smoke.closure_phase(dev)
            print(f"closure_phase {i} ({name}): passed, points {out['gba_pts']:.3e} of the "
                  f"extent, projections {out['gba_uv']:.3e} px, poses {out['gba_pose']:.3e}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        except RuntimeError as e:
            bad[name] += 1
            print(f"closure_phase {i} ({name}): FAILED: {e}", flush=True)
        finally:
            ba._seg_sum = seg_sum
    print(f"closure_phase: {bad['sorted']} of {n} runs failed with the sorted sums, "
          f"{bad['index_add_']} of {n} with index_add_", flush=True)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.utils.gba_repeat")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--closures", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    dev = torch.device("cpu") if a.cpu else torch.device("cuda", 0)
    measure(dev, a.runs)
    if a.closures:
        closures(a.closures)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
