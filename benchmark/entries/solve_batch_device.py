"""Adapter: ``solve_batch`` on device-resident dense costs.

One call solves one pool batch ``[B, N, N]`` with ``costs=None`` and
``costs_device`` set (the device-resident mode: the objective on the
device, stragglers kept there), with the cell's ``entry_args``.
"""

from __future__ import annotations

from sparse_linear_assignment_tpu_torch import solve_batch


def call(ctx, keys: list) -> list:
    return [solve_batch(None, costs_device=ctx.pool[k], device=ctx.device,
                        **ctx.args) for k in keys]


def work(spec: dict, world: int) -> tuple:
    """Bytes and operations one call's problem needs at least: each cost
    read once (float32) and the matching written once (person-to-object
    and object-to-person, int32); one comparison a cost."""
    del world  # one card
    b = spec["batch"] * spec["batches_per_call"]
    n, m = spec["rows"], spec["cols"]
    return b * n * m * 4 + b * (n + m) * 4, b * n * m
