"""Adapter: ``stage_batch_sparse_device`` then ``solve_batch_sparse_stream``.

One call stages each of its pool batches of arcs on the device (each
staging in a ``bench.stage`` span of the harness) and streams them
through the Khosla kernel with ``window`` batches in flight.
"""

from __future__ import annotations

from torch.profiler import record_function

from benchmark.timeline import STAGE_SPAN
from sparse_linear_assignment_tpu_torch import (
    solve_batch_sparse_stream,
    stage_batch_sparse_device,
)


def call(ctx, keys: list) -> list:
    args = dict(ctx.args)
    window = args.pop("window")
    staged = []
    for k in keys:
        columns, values = ctx.pool[k]
        with record_function(STAGE_SPAN):
            staged.append(stage_batch_sparse_device(
                columns, values, ctx.spec["cols"], **args))
    return solve_batch_sparse_stream(staged, window=window)


def work(spec: dict, world: int) -> tuple:
    """Bytes and operations one call's problem needs at least: each arc
    read once (an int32 column and a float32 value) and the matching
    written once (int32, both directions); one comparison an arc."""
    del world  # one card
    b = spec["batch"] * spec["batches_per_call"]
    n, m, k = spec["rows"], spec["cols"], spec["arcs"]
    return b * n * k * 8 + b * (n + m) * 4, b * n * k
