"""Batched square sparse LAPs after the reference crate's symmetric bench
(config A), made on the device.

The ``sparse_linear_assignment`` crate's ``benches/benchmark.rs:81-157``
(``bench_symmetric_density_1_size_10000``): every cell of a ``rows`` x
``cols`` square is an arc with probability ``density``, a shuffled
perfect matching is added to them so that every instance is feasible,
and each arc's value is drawn uniformly from ``[value_low, value_high)``
(``generators.gen_symmetric_input`` in the port).  Here a row's count of
Bernoulli arcs is drawn as ``Binomial(cols, density)`` and that many
distinct columns as a uniformly random subset, the same law as the
cell-by-cell draw without a ``rows x cols`` draw an instance; the
ensured column joins them if it is not among them.  A row holds at most
``arcs`` slots (the workload's width), padded with ``-1``: a count of
``arcs`` or more (a probability of 3.2e-12 a row at 10,000 columns,
density 1% and 176 slots) is cut to ``arcs - 1`` before the ensured
column joins.
Values are float32: a uniform float64 draw rounded to float32, held
below ``value_high`` where it rounds up to it.  A pool item is
``(columns [batch, rows, arcs] int32, values [batch, rows, arcs]
float32)``, the arcs first in each row; no ``[batch, rows, cols]`` tensor
is made.
"""

from __future__ import annotations

import torch

from benchmark.seeds import generator


def _distinct(g, rows: int, m: int, k: int, device) -> torch.Tensor:
    """``[rows, k]`` int32 columns of ``[0, m)``, distinct in each row:
    uniform draws, a slot whose column an earlier slot of its row holds
    drawn again until none is.  The rule treats every column alike, so
    the first ``c`` slots of a row are a uniformly random ``c``-subset."""
    cols = torch.randint(0, m, (rows, k), generator=g, device=device,
                         dtype=torch.int32)
    while True:
        ordered, at = cols.sort(dim=1, stable=True)
        again = torch.zeros_like(cols, dtype=torch.bool)
        again.scatter_(1, at[:, 1:], ordered[:, 1:] == ordered[:, :-1])
        count = int(again.sum())
        if count == 0:
            return cols
        cols[again] = torch.randint(0, m, (count,), generator=g,
                                    device=device, dtype=torch.int32)


def _batch(g, b: int, n: int, k: int, config: dict, device):
    if not 2 <= k <= n + 1:
        raise ValueError(f"{k} slots a row do not fit {n} columns")
    density = config["density"]
    counts = torch.binomial(
        torch.full((b * n,), float(n), dtype=torch.float64, device=device),
        torch.full((b * n,), density, dtype=torch.float64, device=device),
        generator=g).long().clamp(max=k - 1)
    cols = _distinct(g, b * n, n, k - 1, device)
    slot = torch.arange(k, device=device)
    cols = torch.where(slot[:k - 1] < counts[:, None], cols, -1)
    # the ensured perfect matching: a uniform permutation an instance
    ensured = torch.rand((b, n), generator=g, device=device,
                         dtype=torch.float64).argsort(dim=1)
    ensured = ensured.reshape(-1, 1).to(torch.int32)
    missing = ~(cols == ensured).any(dim=1)
    cols = torch.cat([cols, torch.full_like(cols[:, :1], -1)], dim=1)
    cols.scatter_(1, counts[:, None], torch.where(
        missing[:, None], ensured, cols.gather(1, counts[:, None])))
    lo, hi = config["value_low"], config["value_high"]
    vals = (lo + (hi - lo) * torch.rand((b * n, k), generator=g,
                                        device=device, dtype=torch.float64)
            ).to(torch.float32)
    below = torch.nextafter(torch.tensor(float(hi), dtype=torch.float32),
                            torch.tensor(0.0, dtype=torch.float32))
    vals = torch.where(vals >= hi, below.to(device), vals)
    vals = torch.where(cols >= 0, vals, 0.0)
    return cols.view(b, n, k), vals.view(b, n, k)


def make(cell: dict, config: dict, seed: int, device) -> list:
    """The cell's pool: ``cell["pool"]`` distinct batches of arcs, each
    from its own seed, made on ``device``."""
    return [_batch(generator(seed, i, device), cell["batch"], cell["rows"],
                   cell["arcs"], config, device)
            for i in range(cell["pool"])]


def reference_costs(item, idx: torch.Tensor, cell: dict) -> torch.Tensor:
    """Instances ``idx`` of one pool batch as float64 ``[S, rows, cols]``
    cost matrices, ``inf`` where a person has no arc (a ``-1`` pad lands
    in a column past the last, cut off)."""
    columns, values = item
    idx = idx.to(columns.device)
    c = columns[idx].long()
    v = values[idx].to(torch.float64)
    s, n, _ = c.shape
    m = cell["cols"]
    full = torch.full((s, n, m + 1), float("inf"), dtype=torch.float64,
                      device=columns.device)
    full.scatter_(2, torch.where(c >= 0, c, m), torch.where(
        c >= 0, v, float("inf")))
    return full[:, :, :m]


def coarsen(item, dtype: torch.dtype):
    """The arcs with their values rounded through ``dtype``."""
    columns, values = item
    return columns, values.to(dtype).to(values.dtype)
