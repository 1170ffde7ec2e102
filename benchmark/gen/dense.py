"""Dense square LAP batches with integer costs, made on the device.

A frozen rewrite in PyTorch of the dense recipes the JAX package's
``bench.py`` used (``bench_batched``: ``randint(1, 1000)`` as float32,
4096 x 256 x 256 a batch; ``bench_dense_single``: one n x n instance of
the same law): each pool batch is ``[batch, rows, cols]`` float32 integer
costs drawn uniformly from ``[cost_low, cost_high)``.
"""

from __future__ import annotations

import torch

from benchmark.seeds import generator


def make(cell: dict, config: dict, seed: int, device) -> list:
    """The cell's pool: ``cell["pool"]`` distinct batches, each made by
    one ``randint`` on ``device`` from its own seed."""
    shape = (cell["batch"], cell["rows"], cell["cols"])
    pool = []
    for k in range(cell["pool"]):
        g = generator(seed, k, device)
        pool.append(torch.randint(
            config["cost_low"], config["cost_high"], shape, generator=g,
            device=device, dtype=torch.int32,
        ).to(torch.float32))
    return pool


def reference_costs(item: torch.Tensor, idx: torch.Tensor,
                    cell: dict) -> torch.Tensor:
    """Instances ``idx`` of one pool batch as float64 ``[S, rows, cols]``
    cost matrices, the plain reference's input."""
    del cell
    return item[idx.to(item.device)].to(torch.float64)


def coarsen(item: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The batch's costs rounded through ``dtype`` (a control's input)."""
    return item.to(dtype).to(item.dtype)

