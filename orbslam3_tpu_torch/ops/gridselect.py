"""Spatially uniform keypoint selection (replaces the CPU quadtree).

Counterpart of `orbslam3_tpu/ops/gridselect.py`: bucket candidates into a
regular grid and select in round-robin rank order (every cell's best
candidate first, then every cell's second best, ...) until the budget is
filled, with two sorts instead of a sequential tree.

Both sorts are stable (`jnp.argsort` is; `torch.argsort` only with
`stable=True`): the keys tie within a cell, and the tie order decides
which candidates survive the budget.
"""

from __future__ import annotations

import torch

_I32_MAX = 2 ** 31 - 1


def select_uniform(xy: torch.Tensor, response: torch.Tensor, valid: torch.Tensor,
                   hw: tuple[int, int], grid: tuple[int, int],
                   budget: int) -> torch.Tensor:
    """Pick `budget` candidate indices, spatially spread.

    xy: (M, 2) float pixel coords; response: (M,); valid: (M,) bool.
    hw: image (h, w); grid: (rows, cols).  Returns (budget,) int64 indices
    into the candidate arrays, -1 where fewer than `budget` valid
    candidates exist.
    """
    m = xy.shape[0]
    rows, cols = grid
    h, w = hw
    cy = torch.clamp((xy[:, 1] * (rows / h)).to(torch.int32), 0, rows - 1)
    cx = torch.clamp((xy[:, 0] * (cols / w)).to(torch.int32), 0, cols - 1)
    cell = cy * cols + cx
    n_cells = rows * cols

    # responses quantized to integers (FAST scores <= 255) so the
    # lexicographic sort keys are exact in int32
    r = torch.clamp(response, 0.0, 4094.0)
    rq = (r * 16.0).to(torch.int32)
    maxr = 1 << 16

    cell_v = torch.where(valid, cell, torch.full_like(cell, n_cells))
    # pass 1: sort by (cell asc, response desc)
    key1 = cell_v * maxr + (maxr - 1 - rq)
    order1 = torch.argsort(key1, stable=True)
    cells_s = cell_v[order1]
    rq_s = rq[order1]
    valid_s = valid[order1]

    # rank within cell: index minus index-of-first-element-of-cell
    idx = torch.arange(m, device=xy.device)
    is_first = torch.ones(m, dtype=torch.bool, device=xy.device)
    is_first[1:] = cells_s[1:] != cells_s[:-1]
    cell_start = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    rank = (idx - cell_start).to(torch.int32)

    # pass 2: sort by (rank asc, response desc); invalids pushed to the end
    key2 = torch.where(valid_s, rank * maxr + (maxr - 1 - rq_s),
                       torch.full_like(rq_s, _I32_MAX))
    order2 = torch.argsort(key2, stable=True)
    chosen = order1[order2[:budget]]
    ok = valid_s[order2[:budget]]
    return torch.where(ok, chosen, torch.full_like(chosen, -1))
