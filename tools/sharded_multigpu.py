#!/usr/bin/env python3
"""The sharded modes on a world of N NCCL ranks, one card each, against a
world of one.

    python3 tools/sharded_multigpu.py [--ranks N] [--device cuda|cpu]

Run from the root of a checkout on a machine with N CUDA GPUs (default
4).  It starts a world of N ranks and a world of one
(``parallel/dryrun.RankPool``, NCCL, rank r on card r), and runs every
sharded entry point on both from the same seeded inputs, which each
rank makes itself: the batch-sharded FR solve (1024 x 256², integer
costs, the FR kernel on each card's slice), its stream (3 batches of
512 x 256²), the batch-sharded sparse solve (1024 x (128 x 512,
k = 8), the Khosla kernel), the object-sharded dense FR single (1024²),
``solve_sharded_khosla`` on the reference crate's config B (2,000 x
60,000, k = 32) and ``solve_sharded_forward`` on config A at n = 3,000
(density 1%).  Every rank of a world must return the same bits, and the
world of N the same bits as the world of one.  Prints the card line,
one JSON line a case (each world's wall, ended by the ranks' results
arriving) and a last line with ``"ok"``; exits non-zero on a mismatch.

``--device cpu`` is the rehearsal: gloo ranks on the CPU at cut sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import sparse_linear_assignment_tpu_torch as port  # noqa: E402
from sparse_linear_assignment_tpu_torch.parallel import (  # noqa: E402
    dryrun,
    sharded,
)

SEED = 20261017


def case_batch(b, n, device=None):
    costs = np.random.default_rng(SEED).integers(
        1, 1000, size=(b, n, n)).astype(np.float32)
    dev = torch.from_numpy(costs).to(device or "cuda")
    return sharded.solve_batch_sharded(costs, costs_device=dev,
                                       integer=True, max_cost=1000,
                                       device=device)


def case_stream(b, n, device=None):
    rng = np.random.default_rng(SEED + 1)
    batches = [torch.from_numpy(rng.integers(1, 1000, size=(b, n, n))
                                .astype(np.float32)).to(device or "cuda")
               for _ in range(3)]
    return sharded.solve_batch_sharded_stream(
        batches, integer=True, max_cost=1000, window=2, device=device)


def case_sparse(b, n, m, k, device=None):
    cols, vals = port.generators.gen_batch_ksparse(SEED, b, n, m, k)
    return sharded.solve_batch_sparse_sharded(cols, vals, m, device=device)


def case_fr_dense(n, device=None):
    costs = np.random.default_rng(SEED + 2).integers(
        1, 1000, size=(n, n)).astype(np.float64)
    return sharded.solve_fr_dense_sharded(costs, device=device)


def case_khosla(n, m, k, device=None):
    solver, _ = port.KhoslaSolver.new(n, m, n * k)
    port.generators.gen_asymmetric_input(solver, SEED, n, m, k, 300.0,
                                         700.0)
    return dryrun.run_solver(sharded.solve_sharded_khosla, solver,
                             device=device)


def case_forward(n, device=None):
    solver, _ = port.ForwardAuctionSolver.new(n, n, n * n // 50)
    port.generators.gen_symmetric_input(solver, SEED, n, 0.01, 500.0,
                                        1000.0)
    return dryrun.run_solver(sharded.solve_sharded_forward, solver,
                             device=device)


def cases(full: bool) -> list:
    """``(name, fn, args)``: the card's sizes, or the rehearsal's."""
    if full:
        return [("batch", case_batch, (1024, 256)),
                ("stream", case_stream, (512, 256)),
                ("sparse", case_sparse, (1024, 128, 512, 8)),
                ("fr_dense", case_fr_dense, (1024,)),
                ("khosla", case_khosla, (2000, 60000, 32)),
                ("forward", case_forward, (3000,))]
    return [("batch", case_batch, (6, 128)),
            ("stream", case_stream, (4, 128)),
            ("sparse", case_sparse, (6, 16, 128, 4)),
            ("fr_dense", case_fr_dense, (64,)),
            ("khosla", case_khosla, (40, 300, 6)),
            ("forward", case_forward, (300,))]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda")
    args = parser.parse_args()
    on_card = args.device == "cuda"
    if on_card:
        if torch.cuda.device_count() < args.ranks:
            print(f"sharded_multigpu: {args.ranks} ranks need as many "
                  f"cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        print(json.dumps({"cards": card}), flush=True)
        # build the kernels once, before the ranks load them
        from sparse_linear_assignment_tpu_torch.ops import _build

        _build.build_all()
    backend = "nccl" if on_card else "gloo"
    device = None if on_card else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        pools = {d: dryrun.RankPool(d, os.path.join(tmp, f"store{d}"),
                                    backend=backend)
                 for d in (1, args.ranks)}
        try:
            for name, fn, fargs in cases(on_card):
                results, walls = {}, {}
                for d, pool in pools.items():
                    t0 = time.perf_counter()
                    results[d] = pool.run(fn, *fargs, device=device)
                    walls[d] = time.perf_counter() - t0
                if not dryrun.same(results[1], results[args.ranks]):
                    raise AssertionError(
                        f"{name}: world of {args.ranks} differs from a "
                        f"world of one")
                print(json.dumps({"case": name, "args": fargs,
                                  "ranks": args.ranks, "bit_equal": True,
                                  "wall_s_world_1": walls[1],
                                  f"wall_s_world_{args.ranks}":
                                      walls[args.ranks]}), flush=True)
            audit = pools[args.ranks].run(dryrun.collective_audit,
                                          device=device)
            if not dryrun.audit_matches(audit):
                raise AssertionError(f"collective audit: {audit}")
            print(json.dumps({"collective_audit": audit}), flush=True)
        finally:
            for pool in pools.values():
                pool.close()
    print(json.dumps({"ok": True, "ranks": args.ranks,
                      "backend": backend}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
