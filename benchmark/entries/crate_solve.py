"""Adapter: the crate's API, one instance a call.

``prepare`` turns each pool instance into host CSR rows (pads dropped,
the rows and each row's slots in their order, float64 values).  A call
builds a fresh ``KhoslaSolver`` from the next instance's rows with
``extend_from_csr``, as the crate's Criterion harness clones a built
solver for each timed solve, inside the harness's ``bench.stage`` span,
then calls ``solve(solution, False, ..., device=<the cell's device>)``
with the workload's ``entry_args``.  Nothing staged outlives a call.
The answer comes back as a batch of one: the solution's maps, its
unassigned count, ``get_objective`` and the solver's ``nits``.
"""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from benchmark import plugins
from benchmark.timeline import STAGE_SPAN
from sparse_linear_assignment_tpu_torch import (BatchSolution, KhoslaSolver,
                                                batch)


def prepare(ctx) -> None:
    """Each pool instance as ``(j_counts, column_indices, values)`` on
    the host, in ``ctx.state["csr"]``.  Raises where the program has no
    arc ladder route for ``KhoslaSolver`` (``batch.solve_csr_scaled``):
    its scaled solve then runs the slot-list rounds, about 10 s an
    instance on an H100, and a traced run of them does not end in a
    run's time."""
    if not hasattr(batch, "solve_csr_scaled"):
        raise RuntimeError("this program's KhoslaSolver.solve has no arc "
                           "ladder route, which this cell measures")
    if ctx.spec["batch"] != 1:
        raise ValueError("the crate's API takes one instance a call: "
                         "batch must be 1")
    csr = []
    for columns, values in ctx.pool:
        cols = columns[0].cpu().numpy()
        vals = values[0].cpu().numpy()
        arcs = cols >= 0
        csr.append((arcs.sum(axis=1), cols[arcs],
                    vals[arcs].astype(np.float64)))
    ctx.state["csr"] = csr


def call(ctx, keys: list) -> list:
    out = []
    n, m = ctx.spec["rows"], ctx.spec["cols"]
    for k in keys:
        counts, columns, values = ctx.state["csr"][k]
        with record_function(STAGE_SPAN):
            solver, solution = KhoslaSolver.new(n, m, len(values))
            solver.init(n, m)
            solver.extend_from_csr(counts, columns, values)
        solver.solve(solution, False, device=ctx.device, **ctx.args)
        out.append(BatchSolution(
            person_to_object=np.asarray(solution.person_to_object)[None],
            object_to_person=np.asarray(solution.object_to_person)[None],
            num_unassigned=np.array([solution.num_unassigned], np.int32),
            objective=np.array([solver.get_objective(solution)]),
            eps=np.array([solution.eps], np.float64),
            nits=np.array([solver.nits]),
        ))
    return out


def work(spec: dict, world: int) -> tuple:
    """``stage_sparse_stream``'s count at one instance a call: each arc
    read once (an int32 column and a float32 value) and the matching
    written once (int32, both directions); one comparison an arc."""
    return plugins.load_module("entries", "stage_sparse_stream").work(
        spec, world)
