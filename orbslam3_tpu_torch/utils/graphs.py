"""CUDA-graph replay of the tracking layer's fixed-schedule device functions.

What it replaces: per-op launches.  The JAX package jits each pose
optimization into one XLA program (`orbslam3_tpu/solver/pose_opt.py`,
`orbslam3_tpu/solver/vi_pose_opt.py`); the port runs the same arithmetic
eagerly, and a pose-only optimization issues ~4,200 kernel launches, a
visual-inertial one ~44,800, each costing the host tens of microseconds
while the card waits.  A function qualifies when its schedule is fixed in
Python (rounds and steps), its shapes are fixed per caller (masks do the
selecting) and it reads nothing back to the host: then one capture holds
every kernel of a call, and a replay is one `cudaGraphLaunch`.

What bounds a replay: the device time of the captured kernels (tens of
thousands of small kernels at a few microseconds each); the host pays the
input copies, the launch and the output clones.

`run(body, *args)`, the policy:

  * the arguments are flattened with `torch.utils._pytree` (NamedTuples of
    tensors such as `PreintFactor` and `VIPosePrior` included); the
    signature is the tensor leaves' shape, dtype, device and contiguity and
    the other leaves' values (camera model, schedule, thresholds);
  * a call with a tensor off the card runs `body` eagerly, always;
  * on the card, the first call of a signature runs eagerly, the second
    captures (a warm-up run on a side stream, then `torch.cuda.graph`) and
    every later one replays; one-off shapes are never captured;
  * a replay copies each tensor argument into the graph's static input,
    replays on the caller's current stream and returns a clone of every
    output tensor, so that a returned tensor is never overwritten by a
    later replay;
  * at most `MAX_GRAPHS` graphs are kept, the least recently used evicted.

Each call counts one of `graph.eager`, `graph.capture` or `graph.replay`
on the program's tracer (`utils/profiling.count`), in the open span.  A
capture that fails raises.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch
from torch.utils import _pytree as pytree

from . import profiling

# graphs kept at once (least recently used out), and signatures remembered
# as seen once
MAX_GRAPHS = 8
MAX_SEEN = 32

_GRAPHS: OrderedDict = OrderedDict()   # signature -> _Graph
_SEEN: OrderedDict = OrderedDict()     # signatures seen once, not captured
_LOCK = threading.Lock()


class _Graph:
    """One captured call of `body`: static inputs, the graph, static outputs."""

    def __init__(self, body, leaves: list, spec):
        self.static = [torch.empty_like(x).copy_(x) if isinstance(x, torch.Tensor) else x
                       for x in leaves]
        self.inputs = [x for x in self.static if isinstance(x, torch.Tensor)]
        args = pytree.tree_unflatten(self.static, spec)
        dev = self.inputs[0].device
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            body(*args)
        caller.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(self.graph,
                                                      capture_error_mode="thread_local"):
            out = body(*args)
        self.out_leaves, self.out_spec = pytree.tree_flatten(out)
        self.stream = caller

    def __call__(self, tensors: list):
        stream = torch.cuda.current_stream(self.inputs[0].device)
        if stream != self.stream:
            # the last replay's reads of the inputs and the clones of its
            # outputs were ordered on another stream
            stream.wait_stream(self.stream)
            self.stream = stream
        for buf, x in zip(self.inputs, tensors):
            buf.copy_(x)
        self.graph.replay()
        clones = {}
        out = [clones.setdefault(id(x), x.clone()) if isinstance(x, torch.Tensor) else x
               for x in self.out_leaves]
        return pytree.tree_unflatten(out, self.out_spec)


def _on_card(tensors: list) -> bool:
    """Every tensor argument on one CUDA device."""
    return bool(tensors) and all(x.is_cuda for x in tensors) and \
        len({x.device for x in tensors}) == 1


def _signature(body, leaves: list, spec):
    """The key of a call, or None where a non-tensor leaf is no plain value."""
    sig = [body, spec]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.dtype, x.device, x.is_contiguous()))
        elif x is None or isinstance(x, (bool, int, float, str)):
            sig.append((type(x), x))
        else:
            return None
    return tuple(sig)


def run(body, *args):
    """`body(*args)`, eagerly or as a replay of its captured graph (see the
    module's note)."""
    leaves, spec = pytree.tree_flatten(args)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    key = _signature(body, leaves, spec) if _on_card(tensors) else None
    if key is not None:
        with _LOCK:
            graph = _GRAPHS.get(key)
            if graph is not None:
                _GRAPHS.move_to_end(key)
                profiling.count("graph.replay")
                return graph(tensors)
            if key in _SEEN:
                del _SEEN[key]
                graph = _Graph(body, leaves, spec)
                _GRAPHS[key] = graph
                if len(_GRAPHS) > MAX_GRAPHS:
                    _GRAPHS.popitem(last=False)
                profiling.count("graph.capture")
                return graph(tensors)
            _SEEN[key] = None
            if len(_SEEN) > MAX_SEEN:
                _SEEN.popitem(last=False)
    profiling.count("graph.eager")
    return body(*args)


def clear() -> None:
    """Drop every graph and every signature seen."""
    with _LOCK:
        _GRAPHS.clear()
        _SEEN.clear()
