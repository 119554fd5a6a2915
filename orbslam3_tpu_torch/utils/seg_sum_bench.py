"""Deterministic segment sums on the card: which way of summing the bundle
adjuster's rows by destination repeats bit for bit, and at what cost.

    python -m orbslam3_tpu_torch.utils.seg_sum_bench

`solver/ba._seg_sum(n, idx, vals)` sums the rows of `vals` (O, ...) into n
destinations.  On a card `index_add_` does it with atomics, whose order
changes from run to run.  At the shapes of phase 9b's post-loop GBA (256
cameras, 24,576 points, 196,608 rows) and of the pod drive's (1,024 /
98,304 / 786,432), for the camera sums (rows of 6 and 36) and the point
sums (rows of 3 and 9), this times each candidate by CUDA events (median
of 20 calls) and says whether 5 calls give the same bits and how far the
result lies from a float64 sum:

  * `index_add_` (atomics), the way it was;
  * `index_put_(accumulate=True)` (sorts, then one warp per destination);
  * a stable sort and `segment_reduce` over the rows;
  * a stable sort, the rows transposed, and `segment_reduce` over one
    column at a time (1-D segments);
  * a CSR matrix of ones (destinations x rows) times the rows (cuSPARSE);
  * for up to 1,024 destinations, chunks of one-hot rows times the rows
    (cuBLAS), the partials summed in order.
"""

from __future__ import annotations

import statistics

import torch

SHAPES = (("gba cameras", 256, 196608, 6), ("gba cameras", 256, 196608, 36),
          ("gba points", 24576, 196608, 3), ("gba points", 24576, 196608, 9),
          ("pod cameras", 1024, 786432, 6), ("pod points", 98304, 786432, 3))


def atomic(n, idx, vals):
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)


def put(n, idx, vals):
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_put_((idx,), vals, accumulate=True)


def _sorted(n, idx):
    order = torch.argsort(idx, stable=True)
    lengths = torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))
    return order, lengths


def rows(n, idx, vals):
    order, lengths = _sorted(n, idx)
    return torch.segment_reduce(vals[order], "sum", lengths=lengths, unsafe=True)


def columns(n, idx, vals):
    order, lengths = _sorted(n, idx)
    w = vals[0].numel()
    cols = vals[order].reshape(-1, w).T.reshape(-1)          # column by column
    s = torch.segment_reduce(cols, "sum", lengths=lengths.repeat(w), unsafe=True)
    return s.reshape(w, n).T.reshape((n,) + vals.shape[1:])


def csr(n, idx, vals):
    order, lengths = _sorted(n, idx)
    crow = torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])
    A = torch.sparse_csr_tensor(crow, order, torch.ones(idx.shape[0], dtype=vals.dtype,
                                                        device=vals.device), (n, idx.shape[0]))
    return (A @ vals.reshape(idx.shape[0], -1)).reshape((n,) + vals.shape[1:])


def onehot(n, idx, vals, chunk=16384):
    """Chunks of rows as one-hot (rows x n) matrices, transposed, times the
    rows (cuBLAS), the chunks' partials summed in order."""
    if n > 1024:
        return None
    v = vals.reshape(idx.shape[0], -1)
    parts = [torch.nn.functional.one_hot(idx[i:i + chunk], n).to(v.dtype).T @ v[i:i + chunk]
             for i in range(0, idx.shape[0], chunk)]
    return torch.stack(parts).sum(0).reshape((n,) + vals.shape[1:])


WAYS = {"index_add_": atomic, "index_put_": put, "sort+segment_reduce rows": rows,
        "sort+segment_reduce columns": columns, "sort+CSR matmul": csr,
        "one-hot matmul": onehot}


def measure(dev, calls: int = 20, repeats: int = 5) -> list:
    out = []
    g = torch.Generator(device="cpu").manual_seed(0)
    for name, n, O, w in SHAPES:
        idx = torch.randint(0, n, (O,), generator=g).to(dev)
        vals = torch.randn((O, w), generator=g).to(dev)
        ref = atomic(n, idx.cpu(), vals.cpu().double())
        for way, fn in WAYS.items():
            if (way == "index_put_" and n < 4096 and O > 200000) or \
                    (way == "one-hot matmul" and n > 1024):
                continue                                     # seconds per call; too large
            res = [fn(n, idx, vals) for _ in range(repeats)]
            same = all(torch.equal(res[0], r) for r in res[1:])
            err = float((res[0].cpu().double() - ref).abs().max())
            ms = []
            for _ in range(calls):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn(n, idx, vals)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            row = dict(shape=f"{name} n={n} rows={O} width={w}", way=way, same=same, err=err,
                       ms=statistics.median(ms))
            out.append(row)
            print(f"{row['shape']}: {way}: {row['ms']:.3f} ms, {repeats} calls bit-equal {same}, "
                  f"max |diff| from float64 {err:.3g}", flush=True)
    return out


if __name__ == "__main__":
    measure(torch.device("cuda", 0))
