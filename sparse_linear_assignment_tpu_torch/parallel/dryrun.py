"""Dry run of the sharded modes on gloo CPU ranks, and the rank pool
that runs them.

    python -m sparse_linear_assignment_tpu_torch.parallel.dryrun [N]

The port's counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip``: spawns a world of N gloo ranks
(default 4), runs tiny solves of every sharded engine on it and on its
first rank alone (a subgroup), checks that the results at d = 1 and
d = N are bit-equal, that the collectives give what the world size
implies and that their counts match the audit table of
``parallel/sharded.py``, and prints one line a check.

:class:`RankPool` keeps a world of spawned ranks alive and feeds them
calls: every rank runs the same call on the same arguments (SPMD) and
sends back its result.  The ranks import only torch and this
package.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from . import collectives, sharded


def _rank_main(rank: int, world: int, init_file: str, conn,
               timeout_s: float, backend: str, sizes: tuple) -> None:
    """A rank's loop: join the world through ``init_file`` (an NCCL rank
    takes card ``rank``) and make the subgroups of the first ``s`` ranks
    for each ``s`` in ``sizes``, then run each ``(fn, args, kwargs,
    size)`` received (``size``: over that subgroup, handed to ``fn`` as
    ``group``) and send back ``("ok", result)`` or ``("error",
    exception, traceback)``; ``None`` ends the loop."""
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=timedelta(seconds=timeout_s),
    )
    # every rank makes every subgroup, in one order
    groups = {s: dist.new_group(list(range(s))) for s in sizes}
    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, args, kwargs, size = job
            if size is not None:
                kwargs = dict(kwargs, group=groups[size])
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except Exception as exc:  # sent to the caller, who raises it
                conn.send(("error", exc, traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class RankPool:
    """``world`` ranks in spawned processes, alive until :meth:`close`:
    gloo ranks on the CPU, or with ``backend="nccl"`` one rank a card.
    ``init_file`` is a path that does not exist yet (the ranks'
    ``FileStore``); ``timeout_s`` bounds each collective and each wait
    for a result.  ``sizes`` are smaller worlds that :meth:`run` can
    use: the subgroup of the first ``s`` ranks for each ``s``."""

    def __init__(self, world: int, init_file: str,
                 timeout_s: float = 120.0, backend: str = "gloo",
                 sizes: tuple = ()):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.sizes = tuple(sizes)
        self.timeout_s = timeout_s
        self._conns, self._procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main,
                args=(rank, world, init_file, child, timeout_s, backend,
                      self.sizes),
                daemon=True,
            )
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)

    def run(self, fn, *args, size: int | None = None, **kwargs):
        """``fn(*args, **kwargs)`` on every rank, or with ``size`` (one
        of the pool's ``sizes``) on the first ``size`` ranks with their
        subgroup as ``group``; returns the result, which every rank must
        have returned bit for bit.  A call that failed on every rank
        raises rank 0's exception; one that failed on some, or whose
        results differ, raises."""
        if size is not None and size not in self.sizes:
            raise ValueError(f"size {size} is not one of the pool's "
                             f"subgroups {self.sizes}")
        conns = self._conns[:size or self.world]
        for conn in conns:
            conn.send((fn, args, kwargs, size))
        replies = []
        for rank, conn in enumerate(conns):
            if not conn.poll(self.timeout_s):
                raise TimeoutError(f"rank {rank} sent no result within "
                                   f"{self.timeout_s} s")
            replies.append(conn.recv())
        failed = [r for r in replies if r[0] == "error"]
        if failed and len(failed) == len(replies):
            raise failed[0][1]
        if failed:
            raise RuntimeError("ranks disagree; a failing rank's "
                               "traceback:\n" + failed[0][2])
        for rank, reply in enumerate(replies[1:], 1):
            if not same(replies[0][1], reply[1]):
                raise AssertionError(f"rank {rank}'s result differs from "
                                     f"rank 0's")
        return replies[0][1]

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()


def same(a, b) -> bool:
    """Whether two results are equal bit for bit: arrays, scalars and
    the containers and solution objects that hold them."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same, a, b))
    if hasattr(a, "__dict__"):
        return type(a) is type(b) and same(vars(a), vars(b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def run_solver(fn, solver, **kwargs) -> dict:
    """``fn(solver, **kwargs)`` for the solver entry points
    (``solve_sharded_khosla``, ``solve_sharded_forward``), with what the
    solve leaves on the solver: a picklable dict of the solution, the
    rounds and the solver's prices and counters."""
    solution, nits = fn(solver, **kwargs)
    return {
        "solution": solution, "nits": nits, "prices": solver.prices,
        "objective": solver.get_objective(solution),
        "nreductions": getattr(solver, "nreductions", None),
        "optimal_soln_found": getattr(solver, "optimal_soln_found", None),
    }


# ----------------------------------------------------------------------
# The collectives on rank-dependent inputs
# ----------------------------------------------------------------------
def collectives_probe(group=None, device="cpu") -> dict:
    """Rank-dependent inputs through every collective of
    ``collectives.py``, with the counts from zero; every rank of
    ``group`` must call it.  Raises unless each result is what the
    world size implies (the gathers in rank order, exact reductions,
    bool kept); returns the results as arrays and the counts."""
    dev = collectives.rank_device(group, device)
    rank, world = collectives.shard_index(group)
    collectives.reset_counts()
    v = torch.tensor([rank, -rank, 10 + rank], dtype=torch.float32,
                     device=dev)

    def flag(x):
        return torch.tensor([x], device=dev)

    got = {
        "gather": collectives.all_gather_tiled(v, group),
        "gather_bool": collectives.all_gather_tiled(flag(rank % 2 == 1),
                                                    group),
        "max": collectives.all_reduce(v, "max", group),
        "min": collectives.all_reduce(v.to(torch.int32), "min", group),
        "sum": collectives.all_reduce(v.double(), "sum", group),
        "any": collectives.all_reduce(flag(rank == 0), "max", group),
        "parts": collectives.all_gather_parts(
            [v[:2].double(), torch.full((2, 2), rank, dtype=torch.int32,
                                        device=dev), flag(rank == 1)],
            group),
    }
    got = {k: ([p.cpu().numpy() for p in x] if isinstance(x, list)
               else x.cpu().numpy()) for k, x in got.items()}
    r = np.arange(world)
    total = r.sum()
    want = {
        "gather": np.stack([r, -r, 10 + r], 1).reshape(-1),
        "gather_bool": r % 2 == 1,
        "max": [world - 1, 0, 10 + world - 1],
        "min": [0, -(world - 1), 10],
        "sum": [total, -total, 10 * world + total],
        "any": [True],
        "parts": [np.stack([r, -r], 1).reshape(-1),
                  np.repeat(r, 4).reshape(-1, 2), r == 1],
    }
    dtypes = {"gather": np.float32, "gather_bool": np.bool_,
              "max": np.float32, "min": np.int32, "sum": np.float64,
              "any": np.bool_, "parts": (np.float64, np.int32, np.bool_)}
    for key, value in want.items():
        pairs = (zip(got[key], value, dtypes[key]) if key == "parts"
                 else [(got[key], value, dtypes[key])])
        for g, w, dt in pairs:
            if g.dtype != dt or not np.array_equal(g, w):
                raise AssertionError(f"collective {key}: {g!r}, want {w!r}")
    got["counts"] = dict(collectives.COUNTS)
    return got


# ----------------------------------------------------------------------
# The collective audit
# ----------------------------------------------------------------------
def _counted(fn, *args, **kwargs):
    collectives.reset_counts()
    out = fn(*args, **kwargs)
    return out, dict(collectives.COUNTS)


def _per_round(short: dict, long: dict, rounds: int) -> tuple:
    """Per-round and per-chunk counts from the counts of a chunk of
    ``rounds`` rounds and one of ``2 * rounds``."""
    per_round = {k: (long[k] - short[k]) // rounds for k in short}
    return per_round, {k: short[k] - per_round[k] * rounds for k in short}


def collective_audit(group=None, device="cpu") -> dict:
    """Count each sharded mode's collectives on a small instance: per
    round and per chunk for the Khosla, forward and batched cores (from
    chunks of 2 and 4 rounds), per branch for the dense FR round.
    Every rank of ``group`` must call it."""
    from ..generators import gen_ksparse_uniform
    from ..ksparse import KhoslaSolver
    from ..ops.fr_dense import fr_init

    dev = collectives.rank_device(group, device)
    idx, d = collectives.shard_index(group)
    n, m, k = 16, 24, 3
    solver, _ = KhoslaSolver.new(n, m, n * k)
    gen_ksparse_uniform(solver, 5, n, m, k, max_value=10.0)
    shards, n_pad, m_pad = sharded._padded_shards(solver, d, idx, dev)
    f32 = torch.float32
    prices = torch.zeros(m_pad // d, dtype=f32, device=dev)
    p2o = torch.full((n_pad // d,), sharded.UNASSIGNED, dtype=torch.int32,
                     device=dev)
    o2p = torch.full((m_pad // d,), sharded.UNASSIGNED, dtype=torch.int32,
                     device=dev)
    dropped = torch.zeros(n_pad // d, dtype=torch.bool, device=dev)
    nits = torch.zeros((), dtype=torch.int32, device=dev)

    def scalar(x, dtype=f32):
        return torch.tensor(x, dtype=dtype, device=dev)

    out = {}
    runs = [_counted(sharded.sharded_khosla_core(group, c), *shards,
                     prices, p2o, o2p, dropped, nits, scalar(0.1),
                     scalar(1e6))[1] for c in (2, 4)]
    out["khosla"] = _per_round(*runs, 2)

    valid = torch.ones(n_pad // d, dtype=torch.bool, device=dev)
    runs = [_counted(
        sharded.sharded_forward_core(group, c), *shards, valid, prices,
        p2o, o2p, scalar(5.0), nits, nits, scalar(False, torch.bool),
        scalar(False, torch.bool), scalar(0.1), scalar(0.0),
        scalar(False, torch.bool), scalar(1000, torch.int32), scalar(1e9),
    )[1] for c in (2, 4)]
    out["forward"] = _per_round(*runs, 2)

    rng = np.random.default_rng(3)
    vals_l = torch.from_numpy(
        rng.integers(1, 50, size=(m_pad // d, n)).astype(np.float32)
    ).to(dev)
    state = (
        torch.zeros(m_pad // d, dtype=f32, device=dev),
        o2p, torch.zeros(n, dtype=f32, device=dev),
        torch.full((n,), sharded.UNASSIGNED, dtype=torch.int32,
                   device=dev),
        scalar(True, torch.bool), scalar(False, torch.bool), nits, nits,
        scalar(8, torch.int32), scalar(0.5),
    )
    out["fr_dense"] = {
        branch: _counted(sharded._fr_round_sharded, vals_l, state, fwd,
                         group)[1]
        for branch, fwd in (("forward_round", True),
                            ("reverse_round", False))
    }

    vt = torch.from_numpy(
        rng.integers(1, 50, size=(2, n, n)).astype(np.float32)).to(dev)
    st = fr_init(vt, 1.0 / n)
    runs = [_counted(sharded.sharded_fr_batch_core(group, c), vt, st,
                     10_000)[1] for c in (2, 4)]
    out["batched"] = _per_round(*runs, 2)
    return out


#: the audit table of ``parallel/sharded.py``: per round and per chunk
AUDIT_TABLE = {
    "khosla": ({"all_gather": 5, "max": 0, "min": 0, "sum": 1},
               {"all_gather": 0, "max": 0, "min": 0, "sum": 1}),
    "forward": ({"all_gather": 6, "max": 0, "min": 0, "sum": 3},
                {"all_gather": 0, "max": 0, "min": 0, "sum": 0}),
    "batched": ({"all_gather": 0, "max": 0, "min": 0, "sum": 0},
                {"all_gather": 0, "max": 0, "min": 0, "sum": 1}),
}

#: the dense FR row: both branches of a round together, and each
FR_DENSE_TABLE = {"all_gather": 0, "max": 3, "min": 4, "sum": 1}
FR_DENSE_BRANCHES = {
    "forward_round": {"all_gather": 0, "max": 2, "min": 2, "sum": 1},
    "reverse_round": {"all_gather": 0, "max": 1, "min": 2, "sum": 0},
}


def audit_matches(audit: dict) -> bool:
    """Whether ``collective_audit``'s counts are the table's."""
    both = {k: sum(b[k] for b in audit["fr_dense"].values())
            for k in FR_DENSE_TABLE}
    return (
        all(tuple(audit[mode]) == AUDIT_TABLE[mode] for mode in AUDIT_TABLE)
        and audit["fr_dense"] == FR_DENSE_BRANCHES
        and both == FR_DENSE_TABLE
    )


# ----------------------------------------------------------------------
# The dry run
# ----------------------------------------------------------------------
def _tiny_cases(n_ranks: int) -> list:
    """``(name, fn, args, kwargs)`` of a tiny solve of every sharded
    engine, the port's versions of ``dryrun_multichip``'s."""
    from ..generators import gen_ksparse_uniform
    from ..ksparse import KhoslaSolver
    from ..symmetric import ForwardAuctionSolver

    rng = np.random.default_rng(7)
    ksolver, _ = KhoslaSolver.new(32, 64, 32 * 4)
    gen_ksparse_uniform(ksolver, 3, 32, 64, 4, max_value=10.0)
    n2 = 48
    costs = rng.integers(1, 100, size=(n2, n2)).astype(np.float64)
    fsolver, _ = ForwardAuctionSolver.new(n2, n2, n2 * n2)
    fsolver.init(n2, n2)
    for i in range(n2):
        fsolver.extend_from_values(i, range(n2), costs[i])
    bcosts = rng.integers(1, 50, size=(2 * n_ranks + 1, 32, 32)).astype(
        np.float64)
    kcosts = rng.integers(1, 100, size=(n_ranks, 128, 128)).astype(
        np.float64)
    sdevs = [torch.from_numpy(rng.integers(1, 200, size=(n_ranks, 128, 128))
                              .astype(np.float32)) for _ in range(2)]
    spb, spn, spm, spk = 2 * n_ranks + 3, 16, 128, 4
    spcols = np.stack([
        np.stack([rng.choice(spm, size=spk, replace=False)
                  for _ in range(spn)]) for _ in range(spb)
    ]).astype(np.int32)
    spvals = rng.integers(1, 50, size=(spb, spn, spk)).astype(np.float64)
    cpu = {"device": "cpu"}
    return [
        ("khosla", run_solver, (sharded.solve_sharded_khosla, ksolver), cpu),
        ("forward", run_solver, (sharded.solve_sharded_forward, fsolver),
         cpu),
        ("fr_dense", sharded.solve_fr_dense_sharded, (costs,),
         {"chunk": 16, **cpu}),
        ("batched", sharded.solve_batch_sharded, (bcosts,),
         {"dtype": np.float64, **cpu}),
        ("batched_kernel", sharded.solve_batch_sharded, (kcosts,),
         {"eps": 1.0 / 129, **cpu}),
        ("stream", sharded.solve_batch_sharded_stream, (sdevs,),
         {"integer": True, "max_cost": 200, **cpu}),
        ("sparse", sharded.solve_batch_sparse_sharded,
         (spcols, spvals, spm), cpu),
    ]


def dryrun_multichip(n_ranks: int = 4) -> None:
    """Run every sharded engine's tiny solve on a world of ``n_ranks``
    gloo ranks and on its first rank alone; raise unless the two agree
    bit for bit, all ranks of a world agree, the collectives give what
    the world size implies and the collective audit holds."""
    with tempfile.TemporaryDirectory() as tmp:
        pool = RankPool(n_ranks, os.path.join(tmp, "store"), sizes=(1,))
        try:
            for size in (1, None):
                pool.run(collectives_probe, size=size)
            print(f"dryrun_multichip collectives ok on d=1 and "
                  f"d={n_ranks}", flush=True)
            for name, fn, args, kwargs in _tiny_cases(n_ranks):
                results = [pool.run(fn, *args, size=size, **kwargs)
                           for size in (1, None)]
                if not same(*results):
                    raise AssertionError(
                        f"{name}: d=1 vs d={n_ranks} differ")
                print(f"dryrun_multichip {name} ok: d=1 and d={n_ranks} "
                      f"bit-identical", flush=True)
            audit = pool.run(collective_audit)
            if not audit_matches(audit):
                raise AssertionError(f"collective audit: {audit}")
            print(f"dryrun_multichip collective audit ok: {audit}",
                  flush=True)
        finally:
            pool.close()


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
