"""Adapter: ``parallel.solve_batch_sharded`` over the run's process group.

Every rank passes the full batch: the host copy (the entry's ``costs``,
made once in ``prepare``) and the tensor on its own card
(``costs_device``), from which it copies its slice.
"""

from __future__ import annotations

from sparse_linear_assignment_tpu_torch.parallel import solve_batch_sharded


def prepare(ctx) -> None:
    ctx.state["host"] = [x.cpu().numpy() for x in ctx.pool]


def call(ctx, keys: list) -> list:
    return [solve_batch_sharded(ctx.state["host"][k],
                                costs_device=ctx.pool[k], device=ctx.device,
                                **ctx.args) for k in keys]


def work(spec: dict, world: int) -> tuple:
    """Bytes and operations one card's share of a call's problem needs
    at least: each cost of its ``1/world`` of the batch read once
    (float32), the matching written once (int32, both directions); one
    comparison a cost."""
    b = spec["batch"] * spec["batches_per_call"] // world
    n, m = spec["rows"], spec["cols"]
    return b * n * m * 4 + b * (n + m) * 4, b * n * m
