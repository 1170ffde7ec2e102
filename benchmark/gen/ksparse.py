"""Batched asymmetric k-sparse LAPs, made on the device.

A frozen rewrite in PyTorch of ``bench.py``'s ``bench_batched_sparse``
recipe: each person lists ``arcs`` distinct objects, the top ``arcs`` of
uniform scores over ``cols`` objects, with integer values drawn uniformly
from ``[cost_low, cost_high)`` as float32.  A pool item is the pair
``(columns [batch, rows, arcs] int32, values [batch, rows, arcs]
float32)``.
"""

from __future__ import annotations

import torch

from benchmark.seeds import generator


def make(cell: dict, config: dict, seed: int, device) -> list:
    """The cell's pool: ``cell["pool"]`` distinct batches of arcs, each
    from its own seed, in a few large calls on ``device``."""
    b, n, m, k = cell["batch"], cell["rows"], cell["cols"], cell["arcs"]
    pool = []
    for i in range(cell["pool"]):
        g = generator(seed, i, device)
        scores = torch.rand((b, n, m), generator=g, device=device)
        cols = scores.topk(k, dim=2).indices.to(torch.int32)
        del scores
        vals = torch.randint(
            config["cost_low"], config["cost_high"], (b, n, k), generator=g,
            device=device, dtype=torch.int32,
        ).to(torch.float32)
        pool.append((cols, vals))
    return pool


def reference_costs(item, idx: torch.Tensor, cell: dict) -> torch.Tensor:
    """Instances ``idx`` of one pool batch as float64 ``[S, rows, cols]``
    cost matrices, ``inf`` where a person has no arc."""
    columns, values = item
    idx = idx.to(columns.device)
    c = columns[idx].long()
    v = values[idx].to(torch.float64)
    s, n, _ = c.shape
    full = torch.full((s, n, cell["cols"]), float("inf"),
                      dtype=torch.float64, device=columns.device)
    return full.scatter_(2, c, v)


def coarsen(item, dtype: torch.dtype):
    """The arcs with their values rounded through ``dtype``."""
    columns, values = item
    return columns, values.to(dtype).to(values.dtype)

