#!/usr/bin/env python3
"""Eager and graphed chunks of the single sparse device rounds, on one card.

    python3 tools/padded_round_times.py

Run from the root of a checkout on a machine with one CUDA GPU.  On the
headline instance (``gen_symmetric_input(seed=42, n=100,000,
density=5/n, values U[0, 10))``, float32, eps = 1e-5) it times the
full-scan chunk of ``ops/compact.py`` from a fresh state and the
slot-list chunk at each level (8, 512, 4096, 32768 slots, re-packed
after 24 full-scan rounds), and on config A (n = 10,000, density 1%,
values U[500, 1000), float64) the forward chunk of ``ops/auction.py``:
each first run eagerly (the rounds' PyTorch operations launched one by
one from the host), then through ``ops/graphs.run`` (one captured CUDA
graph a shape, the capture excluded from the time), in the order
eager, graphed, graphed, eager.  Every graphed chunk is held equal to
the eager one.  Prints the card line, then one JSON line a case: for
each run, the wall of the chunk ended by a sync over its rounds (ms a
round).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import sparse_linear_assignment_tpu_torch as port  # noqa: E402
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    auction,
    compact,
    graphs,
)
from sparse_linear_assignment_tpu_torch.ops.padded import (  # noqa: E402
    build_padded_problem,
)


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def same(a, b) -> bool:
    a = a[0] if isinstance(a, tuple) and not hasattr(a, "_fields") else a
    b = b[0] if isinstance(b, tuple) and not hasattr(b, "_fields") else b
    return all(torch.equal(x, y) for x, y in zip(a, b))


def case(name, fn, problem, state, scalars, chunk, static=()):
    dev = problem.device
    tensors = [torch.as_tensor(v, dtype=dt, device=dev)
               for v, dt in scalars]

    def eager():
        return fn(problem, state, *tensors, *static, chunk)

    def graphed():
        return graphs.run(fn, problem, state, scalars, chunk, static)

    graphed()  # the capture, not timed
    runs = []
    for label, run in (("eager", eager), ("graphed", graphed),
                       ("graphed", graphed), ("eager", eager)):
        secs, out = wall(run)
        runs.append((label, secs, out))
    assert same(runs[0][2], runs[1][2]), name
    print(json.dumps({
        "case": name, "chunk": chunk,
        "ms_a_round": {f"{label}_{i}": secs / chunk * 1e3
                       for i, (label, secs, _) in enumerate(runs)},
        "graphed_equals_eager": True,
    }), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("padded_round_times: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")

    n = 100_000
    solver, solution = port.KhoslaSolver.new(n, n, 10 * n)
    port.generators.gen_symmetric_input(solver, 42, n, 5.0 / n, 0.0, 10.0)
    solver.init_solve(solution, False)
    problem = build_padded_problem(n, n, solver.j_counts,
                                   solver.column_indices, solver.values,
                                   dtype=np.float32, device=dev)
    f32 = torch.float32
    scalars = ((np.float32(1e-5), f32),
               (np.float32(n / 2 * (10 + 1e-5)), f32))
    fresh = compact.fresh_lstate(torch.zeros(n, dtype=f32, device=dev), n)
    case(f"full_scan n={n}", compact._full_chunk, problem, fresh,
         scalars, 8)
    warm, _ = compact.khosla_full_chunk(problem, fresh, *[v for v, _ in
                                                          scalars], 24)
    for level in (8, 512, 4096, 32768):
        case(f"slot_list level={level}", compact._run_chunk, problem,
             compact.repack_slots(warm, level), scalars, 64)

    nf = 10_000
    fsolver, fsolution = port.ForwardAuctionSolver.new(nf, nf, nf * 200)
    port.generators.gen_symmetric_input(fsolver, 3, nf, 0.01, 500.0, 1000.0)
    fsolver.init_solve(fsolution, False)
    fproblem = build_padded_problem(nf, nf, fsolver.j_counts,
                                    fsolver.column_indices, fsolver.values,
                                    dtype=np.float64, device=dev)
    f64 = torch.float64
    state = auction._forward_init(fproblem, 500.0)
    case(f"forward n={nf}", auction._forward_chunk, fproblem, state,
         ((1e-4, f64), (2.0 ** -44, f64), (False, torch.bool),
          (np.inf, f64)), 64,
         (100_000,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
