"""Batched asymmetric k-sparse LAPs after the reference crate's own bench,
made on the device.

The ``sparse_linear_assignment`` crate's ``benches/benchmark.rs:159-249``
(``bench_asymmetric_num_of_people_and_arcs_per_person``): every person
lists ``arcs`` distinct objects of ``cols``, drawn uniformly (the crate
samples a reservoir), and each arc's value is ``floor(value_span *
Beta(3, 3) + value_low)``, an integer in ``[300, 1000)``.  Here the
columns of a row are drawn uniformly and a row that repeats one is drawn
again, which leaves every set of ``arcs`` distinct columns equally
likely; the columns stay in draw order, unsorted.  Beta(3, 3) is the
median of five uniforms (the third of five order statistics), exact for
integer parameters and drawn from the seeded generator.  A pool item is
``(columns [batch, rows, arcs] int32, values [batch, rows, arcs]
float32)``; no ``[batch, rows, cols]`` tensor is made.
"""

from __future__ import annotations

import torch

from benchmark.seeds import generator

#: instances whose Beta draws are made at once (five uniforms an arc)
_CHUNK = 64


def _distinct_columns(g, rows: int, m: int, k: int, device) -> torch.Tensor:
    """``[rows, k]`` int32 columns of ``[0, m)``, distinct in each row."""
    cols = torch.randint(0, m, (rows, k), generator=g, device=device,
                         dtype=torch.int32)
    while True:
        ordered = cols.sort(dim=1).values
        again = (ordered[:, 1:] == ordered[:, :-1]).any(dim=1).nonzero()[:, 0]
        if again.numel() == 0:
            return cols
        cols[again] = torch.randint(0, m, (again.numel(), k), generator=g,
                                    device=device, dtype=torch.int32)


def _beta33_values(g, shape: tuple, config: dict, device) -> torch.Tensor:
    """Integer values ``floor(span * Beta(3, 3) + low)`` as float32."""
    x = torch.rand((*shape, 5), generator=g, device=device).median(
        dim=-1).values
    return torch.floor(config["value_span"] * x.to(torch.float64)
                       + config["value_low"]).to(torch.float32)


def make(cell: dict, config: dict, seed: int, device) -> list:
    """The cell's pool: ``cell["pool"]`` distinct batches of arcs, each
    from its own seed, made on ``device``."""
    b, n, m, k = cell["batch"], cell["rows"], cell["cols"], cell["arcs"]
    pool = []
    for i in range(cell["pool"]):
        g = generator(seed, i, device)
        cols = _distinct_columns(g, b * n, m, k, device).view(b, n, k)
        vals = torch.cat([_beta33_values(g, (min(_CHUNK, b - lo), n, k),
                                         config, device)
                          for lo in range(0, b, _CHUNK)])
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
