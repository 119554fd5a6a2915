"""CUDA-graph replay of the tracking layer's pose optimizations
(`orbslam3_tpu_torch/utils/graphs.py`, behind
`solver/pose_opt.pose_optimization`, `solver/vi_pose_opt.vi_pose_optimization`
and `vi_pose_optimization_last_frame`).

On the CPU: the helper's policy with the capture stubbed (first sighting
eager, the second captures, then replays; shapes, dtypes, contiguity and
static arguments key apart; the LRU bound evicts; a failed capture raises),
CPU tensors always eager, and the public functions equal to their eager
bodies.  Marked `gpu`, on a card: each optimizer at the cells' keypoint
capacity (`config.euroc_mono()`'s 1200), called at least four times with
fresh inputs from numpy: every output bit-equal to the eager body's on the
same inputs, outputs of earlier calls untouched by later replays, and a
LastFrame chain fed its own returned priors equal to the eager chain.
`python -m pytest tests/test_torch_pose_graphs.py -q -m gpu --noconftest`
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from orbslam3_tpu_torch import config
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.ops import lie
from orbslam3_tpu_torch.solver import inertial, pose_opt, robust, vi_pose_opt
from orbslam3_tpu_torch.utils import graphs, profiling

K4 = (458.654, 457.296, 367.215, 248.375)
CHI2 = robust.CHI2_MONO


@pytest.fixture
def tracer():
    graphs.clear()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        graphs.clear()


def _counts():
    return {k.split(".")[1]: sum(v.values()) for k, v in profiling.counters().items()
            if k.startswith("graph.")}


def _same(a, b) -> bool:
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                            for x, y in zip(la, lb))


# ----------------------------------------------------------------- problems
def _f32(a, dev):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _rot(w):
    return lie.exp_so3(torch.tensor(w, dtype=torch.float64)).numpy()


def _scene(rng, n, Rwc, pwc):
    """n world points seen from camera pose (Rwc, pwc), their noisy
    keypoints, octaves' information and a validity mask with outliers."""
    uv0 = rng.uniform([20, 20], [730, 460], (n, 2))
    depth = rng.uniform(2, 6, n)
    Xc = np.concatenate([(uv0 - K4[2:]) / K4[:2] * depth[:, None], depth[:, None]], 1)
    octave = rng.integers(0, 8, n)
    uv = uv0 + rng.normal(0, 1.0, (n, 2)) * 1.2 ** octave[:, None]
    uv[rng.uniform(size=n) < 0.05] += 20.0
    return Xc @ Rwc.T + pwc, uv, 1.2 ** (-2.0 * octave), rng.uniform(size=n) < 0.9


def pose_args(seed, n, dev):
    """Positional arguments of `pose_optimization` from a perturbed start."""
    rng = np.random.default_rng(seed)
    X, uv, inv_s2, valid = _scene(rng, n, np.eye(3), np.zeros(3))
    R0 = _rot(rng.normal(0, 0.004, 3))
    t0 = rng.normal(0, 0.02, 3)
    return (_f32(R0, dev), _f32(t0, dev), _f32(X, dev), _f32(uv, dev), _f32(inv_s2, dev),
            torch.tensor(valid, device=dev), "pinhole", _f32(K4, dev))


def _factor(rng, Rwb, T, calib, dev):
    """A one-row factor of T seconds of 200 Hz samples of a slow turn."""
    m = int(round(T * 200))
    g = np.array([0.0, 0.0, -imu_ops.GRAVITY_MAGNITUDE])
    gyro = np.array([0.02, -0.05, 0.1]) + rng.normal(0, 1e-3, (m, 3))
    acc = -Rwb.T @ g + rng.normal(0, 1e-2, (m, 3))
    pre = imu_ops.preintegrate(_f32(acc, "cpu"), _f32(gyro, "cpu"), _f32(np.full(m, 0.005), "cpu"),
                               torch.ones(m, dtype=torch.bool), calib, torch.zeros(6), n_valid=m)
    return pytree.tree_map(lambda x: x.to(dev), inertial.factor_from_preint(pre))


def vi_args(seed, n, dev, last_frame: bool, prior=None):
    """Positional arguments of the VI pose optimizations: the frame's start
    state, then the keyframe's state (LastKeyFrame) or the previous
    frame's prior (LastFrame, `prior` if given), the factor and the visual
    terms, with the EuRoC extrinsic."""
    rng = np.random.default_rng(seed)
    _, icfg = config.euroc_mono_inertial()
    Tbc = np.asarray(icfg.Tbc, np.float64).reshape(4, 4)
    calib = imu_ops.ImuCalib.create(icfg.noise_gyro, icfg.noise_acc, icfg.walk_gyro,
                                    icfg.walk_acc, icfg.imu_freq)
    T = 0.05 if last_frame else 0.5
    R_prev, p_prev = _rot(rng.normal(0, 0.3, 3)), rng.normal(0, 1.0, 3)
    v = np.array([0.5, -0.2, 0.1]) + rng.normal(0, 0.05, 3)
    Rwb = R_prev @ _rot(np.array([0.02, -0.05, 0.1]) * T)
    pwb = p_prev + v * T
    Rwc, pwc = Rwb @ Tbc[:3, :3], pwb + Rwb @ Tbc[:3, 3]
    X, uv, inv_s2, valid = _scene(rng, n, Rwc, pwc)
    start = [_f32(Rwb @ _rot(rng.normal(0, 0.005, 3)), dev),
             _f32(pwb + rng.normal(0, 0.02, 3), dev), _f32(v + rng.normal(0, 0.03, 3), dev),
             _f32(np.zeros(6), dev)]
    Rcb = Tbc[:3, :3].T
    vis = (_f32(X, dev), _f32(uv, dev), _f32(inv_s2, dev), torch.tensor(valid, device=dev),
           "pinhole", _f32(K4, dev), _f32(Rcb, dev), _f32(-Rcb @ Tbc[:3, 3], dev),
           imu_ops.gravity(dev))
    factor = _factor(rng, R_prev, T, calib, dev)
    prev = [_f32(R_prev, dev), _f32(p_prev, dev), _f32(v, dev), _f32(np.zeros(6), dev)]
    if not last_frame:
        return (*start, *prev, factor, *vis)
    if prior is None:
        H = np.diag([1e4] * 6 + [1e3] * 3 + [1e5] * 6) * rng.uniform(0.5, 2.0)
        prior = vi_pose_opt.VIPosePrior(*prev, H=_f32(H, dev))
    return (*start, prior, factor, *vis)


# ------------------------------------------------------------ the policy (CPU)
def _stub(monkeypatch):
    """Capture stubbed: every tensor counts as on the card and a 'graph'
    runs the body on the tensors it is handed; returns the captures made."""
    made = []

    class Graph:
        def __init__(self, body, leaves, spec):
            made.append(body)
            self.body, self.leaves, self.spec = body, leaves, spec

        def __call__(self, tensors):
            it = iter(tensors)
            return self.body(*pytree.tree_unflatten(
                [next(it) if isinstance(x, torch.Tensor) else x for x in self.leaves], self.spec))
    monkeypatch.setattr(graphs, "_on_card", lambda tensors: bool(tensors))
    monkeypatch.setattr(graphs, "_Graph", Graph)
    return made


def _scale(x, k):
    return x * k


def _scale_any(x, k):
    return (x[0] if isinstance(x, tuple) else x) * k


def test_first_sighting_eager_second_captures_then_replays(tracer, monkeypatch):
    made = _stub(monkeypatch)
    x = torch.arange(6.0)
    outs = [graphs.run(_scale, x + i, 2.0) for i in range(5)]
    assert _counts() == {"eager": 1, "capture": 1, "replay": 3}
    assert made == [_scale] and len(graphs._GRAPHS) == 1
    assert all(torch.equal(o, (x + i) * 2.0) for i, o in enumerate(outs))


@pytest.mark.parametrize("other", ["shape", "dtype", "static", "contiguity", "structure"])
def test_signatures_key_apart(tracer, monkeypatch, other):
    _stub(monkeypatch)
    x = torch.arange(12.0).reshape(3, 4)
    for _ in range(2):
        graphs.run(_scale_any, x, 2.0)
    y, k = {"shape": (torch.arange(8.0).reshape(2, 4), 2.0),
            "dtype": (x.double(), 2.0),
            "static": (x, 3.0),
            "contiguity": (x.T, 2.0),
            "structure": ((x,), 2.0)}[other]
    got = graphs.run(_scale_any, y, k)
    assert _counts() == {"eager": 2, "capture": 1}
    assert torch.equal(got, (y if other != "structure" else y[0]) * k)
    graphs.run(_scale_any, y, k)
    assert _counts() == {"eager": 2, "capture": 2} and len(graphs._GRAPHS) == 2


def test_least_recently_used_graph_is_evicted(tracer, monkeypatch):
    _stub(monkeypatch)
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    xs = [torch.zeros(n) for n in (1, 2, 3)]
    for x in xs[:2]:
        graphs.run(_scale, x, 1.0)
        graphs.run(_scale, x, 1.0)
    graphs.run(_scale, xs[0], 1.0)         # replay: xs[0] is now the most recent
    graphs.run(_scale, xs[2], 1.0)
    graphs.run(_scale, xs[2], 1.0)         # third capture evicts xs[1]'s graph
    assert _counts() == {"eager": 3, "capture": 3, "replay": 1}
    assert [k[2][0] for k in graphs._GRAPHS] == [(1,), (3,)]
    graphs.run(_scale, xs[1], 1.0)         # seen anew: eager again
    assert _counts()["eager"] == 4


def test_a_failed_capture_raises(tracer, monkeypatch):
    def refused(body, leaves, spec):
        raise RuntimeError("capture refused")
    monkeypatch.setattr(graphs, "_on_card", lambda tensors: True)
    monkeypatch.setattr(graphs, "_Graph", refused)
    x = torch.ones(3)
    graphs.run(_scale, x, 2.0)
    with pytest.raises(RuntimeError, match="capture refused"):
        graphs.run(_scale, x, 2.0)


def test_cpu_tensors_always_run_eagerly(tracer):
    x = torch.arange(4.0)
    for _ in range(4):
        assert torch.equal(graphs.run(_scale, x, 2.0), x * 2.0)
    assert _counts() == {"eager": 4}
    assert not graphs._GRAPHS and not graphs._SEEN


@pytest.mark.parametrize("kind", ["pose", "pose_pnp", "lastkf", "lastframe"])
def test_public_functions_return_their_eager_bodies(tracer, kind):
    """On the CPU each public function runs its eager body once per call,
    with its arguments in the body's order (defaults and keywords too)."""
    if kind == "pose":
        args = pose_args(0, 200, "cpu")
        got = pose_opt.pose_optimization(*args)
        ref = pose_opt._pose_optimization(*args, 4, 3, CHI2, 1e-2)
    elif kind == "pose_pnp":
        args = pose_args(1, 200, "cpu")
        got = pose_opt.pose_optimization(*args, rounds=3, its_per_round=6, chi2_th=7.0,
                                         min_depth=0.05)
        ref = pose_opt._pose_optimization(*args, 3, 6, 7.0, 0.05)
    elif kind == "lastkf":
        args = vi_args(2, 200, "cpu", last_frame=False)
        got = vi_pose_opt.vi_pose_optimization(*args)
        ref = vi_pose_opt._vi_pose_optimization(*args, 4, 5, CHI2)
    else:
        args = vi_args(3, 200, "cpu", last_frame=True)
        got = vi_pose_opt.vi_pose_optimization_last_frame(*args, its_per_round=4)
        ref = vi_pose_opt._vi_pose_optimization_last_frame(*args, 4, 4, CHI2)
    assert _same(got, ref)
    assert int((got[0] if kind == "lastframe" else got).n_inliers) > 100
    assert _counts() == {"eager": 1}


# ------------------------------------------------------------ the reader
def test_replay_share_reads_the_windows_calls():
    """`tracking_graphs.replay_share` over the window's frames: replays over
    replays and eager calls (a capture is neither); None where the window
    counted none."""
    from slambench import run, spans
    try:
        reader = run.load_metric("tracking_graphs.replay_share")     # turns the tracer on
        graphs.clear()
        kinds = ["eager", "capture", "replay", "capture", "eager", "replay", "capture"]
        for f, kind in enumerate(kinds):
            with profiling.span("frame", f):
                if kind:
                    profiling.count("graph." + kind)
        # one ctx each, all alive: `spans.window` caches by the ctx's id
        ctx = [dict(frames=[run.Frame(i, 0.1, True, False, False) for i in frames], slice={})
               for frames in ((3, 4, 5), (6,), (7,))]
        assert reader.read(ctx[0]) == pytest.approx(1 / 2)
        assert reader.read(ctx[1]) is None
        # the port's calls on the CPU: eager, one count each in its frame
        with profiling.span("frame", 7):
            pose_opt.pose_optimization(*pose_args(4, 50, "cpu"))
        assert reader.read(ctx[2]) == 0.0
    finally:
        spans.uninstall()
        graphs.clear()


# ------------------------------------------------------------ on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


N_CELL = config.euroc_mono().orb.n_features


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pose", "lastkf", "lastframe"])
def test_replays_are_bit_equal_to_the_eager_body_on_the_card(tracer, dev, kind):
    public, body, make = {
        "pose": (pose_opt.pose_optimization, pose_opt._pose_optimization,
                 lambda s: pose_args(s, N_CELL, dev)),
        "lastkf": (vi_pose_opt.vi_pose_optimization, vi_pose_opt._vi_pose_optimization,
                   lambda s: vi_args(s, N_CELL, dev, last_frame=False)),
        "lastframe": (vi_pose_opt.vi_pose_optimization_last_frame,
                      vi_pose_opt._vi_pose_optimization_last_frame,
                      lambda s: vi_args(s, N_CELL, dev, last_frame=True)),
    }[kind]
    calls = [make(seed) for seed in range(5)]
    outs = [public(*args) for args in calls]
    torch.cuda.synchronize()
    assert _counts() == {"eager": 1, "capture": 1, "replay": 3}
    defaults = {"pose": (4, 3, CHI2, 1e-2), "lastkf": (4, 5, CHI2),
                "lastframe": (4, 5, CHI2)}[kind]
    for args, out in zip(calls, outs):
        # every output, the first calls' too, against the eager body after
        # the last replay: bit-equal and untouched
        ref = body(*args, *defaults)
        assert _same(out, ref), kind
    if kind != "lastframe":
        return
    # the chain: each call fed the prior the previous call returned
    graphs.clear()
    prior, eager_prior, chain, eager = None, None, [], []
    for seed in range(10, 16):
        out = public(*vi_args(seed, N_CELL, dev, last_frame=True, prior=prior))
        ref = body(*vi_args(seed, N_CELL, dev, last_frame=True, prior=eager_prior), *defaults)
        prior, eager_prior = out[1], ref[1]
        chain.append(out)
        eager.append(ref)
    assert all(_same(a, b) for a, b in zip(chain, eager))
    assert bool(torch.isfinite(chain[-1][1].H).all())
