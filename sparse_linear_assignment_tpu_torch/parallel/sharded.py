"""Sharded auction solves over a 1-D ``torch.distributed`` process group.

The port of the JAX package's ``parallel/sharded.py``, function for
function.  JAX drives a ``Mesh`` from one host process; PyTorch runs
one process a shard (SPMD):

- every rank calls the entry point with the same full inputs, as the
  JAX host does, and stages only its own shard;
- every rank returns the full result: the final matching (and prices,
  or the batch's packed result) is gathered once, where JAX's
  ``np.asarray`` of a sharded array gathers it implicitly;
- in place of ``mesh``, each entry point takes ``group=None``, a 1-D
  process group that the caller has initialised (``None``: the world);
  the shard index is the rank in it.  ``device=None`` means
  ``cuda:{torch.cuda.current_device()}``, ``device="cpu"`` the host;
  the group's backend must fit (NCCL for CUDA tensors, gloo for CPU
  tensors), else ``ValueError``.  An entry point never initialises a
  group itself.

Layout of the single-instance modes (N, M padded to multiples of the
world size D on the host):

- ``row_cols/row_vals/row_mask [K, N]``   sharded on persons (axis 1)
- ``col_persons/col_mask [Kc, M]``        sharded on objects (axis 1)
- ``prices [M]``, ``o2p [M]``             sharded on objects
- ``p2o [N]``, ``dropped [N]``            sharded on persons

Per round each rank gathers the full prices, bids for its persons,
gathers all bids, resolves the conflicts of its objects, gathers the
winners and updates its slices.  Rounds run in host-driven chunks, with
one replicated count read back a chunk, as in the JAX package.  The
collectives live in ``parallel/collectives.py``, which counts them.

Collective audit (the JAX module's table, ``sharded.py:36-46``; pinned by
the port's tests through ``collectives.COUNTS``):

==================  =======================================  ==========
mode                per ROUND                                per CHUNK
==================  =======================================  ==========
khosla (k-sparse)   5 all_gather ([M]x2+[N]x2+[M]) + 1 sum   1 sum
forward (ε-scaled)  6 all_gather (adds the ε-CS certificate
                    price gather) + 3 sum (unassigned,
                    ε-CS violations, price-divergence)       —
dense FR single     3 max + 4 min ([N] vectors) + 1 sum      —
batched (data-par)  ZERO: instances are independent          1 sum
                                                             (all-done)
==================  =======================================  ==========

The dense FR row counts both branches of a round, as JAX's traced
program does (``lax.cond``); a round runs one of them: a forward round
2 max, 2 min and 1 sum, a reverse round 1 max and 2 min.

The batch-sharded modes run the port's kernels on each rank's slice:
``solve_batch_sharded[_stream]`` the FR kernel (``csrc/fr_kernel.cu``)
within its contract (float32 or int32 lattice, N % 128 == 0,
M % 8 == 0, N·M <= 1024², the JAX package's routing), the plain FR
rounds off it; ``solve_batch_sparse_sharded`` the Khosla kernel
(``csrc/ksp_kernel.cu``).  On CPU tensors each kernel wrapper runs its
plain version.  The dense FR single runs plain PyTorch rounds, as JAX
runs XLA rounds there, never the big-single kernel.

What the port drops: the jit caches (``_staging_core`` and the
``lru_cache`` of the cores, which here return the chunk function
itself), the TPU-interpret test hook ``_SHARDED_KERNEL_INTERPRET_ON_CPU``
(a CPU tensor runs the kernel's plain version), and the u16 and
double-double wire formats of the packed readback (the gathered plane
carries int32 indices and the float64 objective's words).
"""

from __future__ import annotations

import functools
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from .. import batch as batch_mod
from ..ops.auction import top2_profits_arrays
from ..ops.fr_dense import STALL_K0 as _STALL_K0
from ..ops.fr_dense import fr_init
from ..ops import graphs
from ..ops.fr_kernel import fr_chunk
from ..ops.ksparse_kernel import khosla_init, ksp_chunk
from ..ops.padded import build_padded_arrays
from ..solution import INDEX_DTYPE, UNASSIGNED, AuctionSolution, \
    o2p_from_p2o
from ..utils.trace import trace_host, trace_round
from .collectives import (
    all_gather_parts,
    all_gather_tiled,
    all_reduce,
    rank_device,
    shard_index,
)

_INT_MAX = UNASSIGNED


# 0-dim fills, not copies from host memory: a copy would wait for the
# device in every round
def _neg_inf(dtype, dev) -> torch.Tensor:
    return torch.full((), -np.inf, dtype=dtype, device=dev)


def _i32(x, dev) -> torch.Tensor:
    return torch.full((), x, dtype=torch.int32, device=dev)


def _pad_to(x, mult: int, axis_i: int) -> np.ndarray:
    """Pad axis ``axis_i`` of ``x`` with zeros up to a multiple of
    ``mult`` on the host."""
    x = np.asarray(x)
    size = x.shape[axis_i]
    target = ((size + mult - 1) // mult) * mult
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis_i] = (0, target - size)
    return np.pad(x, pad)


def _shard(x: np.ndarray, rank: int, d: int, axis_i: int,
           dev) -> torch.Tensor:
    """This rank's contiguous slice of the host array ``x`` along
    ``axis_i`` (a multiple of ``d`` long), on ``dev``."""
    size = x.shape[axis_i] // d
    part = np.take(x, np.arange(rank * size, (rank + 1) * size),
                   axis=axis_i)
    return torch.from_numpy(np.ascontiguousarray(part)).to(dev)


def _padded_shards(solver, d: int, rank: int, dev):
    """The solver's padded dual layout (the port's ``ops/padded.py``
    arrays of ``build_padded_problem``), persons and objects padded to
    multiples of ``d``, and this rank's slices of its five arrays.
    Returns ``(shards, n_pad, m_pad)``."""
    arrays = build_padded_arrays(
        solver.num_rows, solver.num_cols, solver.j_counts,
        solver.column_indices, solver.values, dtype=solver.dtype,
    )
    names = ("row_cols", "row_vals", "row_mask", "col_persons", "col_mask")
    padded = [_pad_to(arrays[k], d, 1) for k in names]
    shards = [_shard(x, rank, d, 1, dev) for x in padded]
    return shards, padded[0].shape[1], padded[3].shape[1]


def _gathered_result(solver, solution, p2o, o2p, prices, group):
    """Gather the final ``p2o``, ``o2p`` and prices once, strip the
    padding and fill ``solution`` and ``solver.prices``."""
    p2o, o2p, prices = all_gather_parts([p2o, o2p, prices], group)
    p2o = p2o.cpu().numpy()[: solver.num_rows]
    o2p = o2p.cpu().numpy()[: solver.num_cols]
    solver.prices = prices.cpu().numpy().astype(np.float64)[
        : solver.num_cols]
    solution.person_to_object = p2o.astype(INDEX_DTYPE)
    solution.object_to_person = o2p.astype(INDEX_DTYPE)
    solution.num_unassigned = int((p2o == UNASSIGNED).sum())


class _Shards:
    """This rank's slices of an instance's padded arrays on its device,
    and the chunks of rounds captured on them (``ops/graphs.py``)."""

    def __init__(self, arrays, device):
        self.arrays = arrays
        self.device = device
        self.graphs = {}


def _resolve_objects(col_persons, col_mask, bid_full, col_full, m_local,
                     idx, neg_inf):
    """Conflict resolution on this rank's objects: each object's
    incident bids that target it, the largest bid, the smallest person
    on ties.  Returns ``(max_bid, has_winner, winner)``, each
    ``[M/D]``."""
    obj_gid = m_local * idx + torch.arange(
        m_local, dtype=torch.int32, device=col_persons.device
    )
    idx_p = col_persons.long()
    inc_bid = bid_full[idx_p]
    inc_tgt = col_full[idx_p]
    is_here = col_mask & (inc_tgt == obj_gid) & (inc_bid != neg_inf)
    eff = torch.where(is_here, inc_bid, neg_inf)
    max_bid = eff.amax(dim=0)
    has_winner = max_bid != neg_inf
    cand = torch.where(is_here & (eff >= max_bid[None, :]), col_persons,
                       _INT_MAX)
    return max_bid, has_winner, cand.amin(dim=0)


def _update_persons(p2o_sh, bidding, best_col, winner_full,
                    has_winner_full, n_local, idx):
    """This rank's persons after the winners are known: a bidder that
    won takes its object, an owner whose object took a bid is
    displaced."""
    person_gid = n_local * idx + torch.arange(
        n_local, dtype=torch.int32, device=p2o_sh.device
    )
    safe_tgt = torch.where(bidding, best_col, 0).long()
    won = bidding & (winner_full[safe_tgt] == person_gid)
    assigned = p2o_sh != _INT_MAX
    safe_cur = torch.where(assigned, p2o_sh, 0).long()
    displaced = assigned & has_winner_full[safe_cur]
    return torch.where(won, best_col,
                       torch.where(displaced, _INT_MAX, p2o_sh))


# ----------------------------------------------------------------------
# Sharded Khosla
# ----------------------------------------------------------------------
def _round_body(row_cols, row_vals, row_mask, col_persons, col_mask, eps,
                threshold, state, group=None):
    """One Jacobi auction round on this rank's shards: 5 all_gathers and
    1 sum."""
    prices_sh, p2o_sh, o2p_sh, dropped_sh, nits, num_active = state
    idx, _ = shard_index(group)
    n_local = p2o_sh.shape[0]
    m_local = prices_sh.shape[0]
    neg_inf = _neg_inf(prices_sh.dtype, prices_sh.device)

    # ---- bidding on the local person shard ----
    prices_full = all_gather_tiled(prices_sh, group)  # [M]
    best, second, best_col, best_val = top2_profits_arrays(
        row_cols, row_vals, row_mask, prices_full
    )
    active = (p2o_sh == _INT_MAX) & ~dropped_sh
    price_at_best = prices_full[best_col.long()]
    drop_now = active & (price_at_best > threshold)
    bidder = active & ~drop_now
    has_second = second != neg_inf
    raw_bid = torch.where(has_second, best_val - second + eps,
                          price_at_best + eps)
    bid_l = torch.where(bidder, raw_bid, neg_inf)

    # ---- gather all bids; resolve conflicts on the local object shard ----
    bid_full = all_gather_tiled(bid_l, group)  # [N]
    col_full = all_gather_tiled(best_col, group)  # [N]
    max_bid, has_winner, winner_l = _resolve_objects(
        col_persons, col_mask, bid_full, col_full, m_local, idx, neg_inf
    )
    prices_new = torch.where(has_winner, max_bid, prices_sh)
    o2p_new = torch.where(has_winner, winner_l, o2p_sh)

    # ---- gather winners; update the local person shard ----
    winner_full = all_gather_tiled(winner_l, group)  # [M]
    has_winner_full = all_gather_tiled(has_winner, group)
    p2o_new = _update_persons(p2o_sh, bidder, best_col, winner_full,
                              has_winner_full, n_local, idx)
    dropped_new = dropped_sh | drop_now
    num_active_new = all_reduce(
        ((p2o_new == _INT_MAX) & ~dropped_new).sum().to(torch.int32),
        "sum", group,
    )
    # rounds after the solve completes (fixed-length chunk tail) are
    # no-ops and must not count
    nits_new = nits + (num_active > 0).to(torch.int32)
    trace_round(
        "sharded khosla round {} shard {}: active={} dropped(local)={}",
        nits, idx, num_active_new, drop_now.sum(),
    )
    return (prices_new, p2o_new, o2p_new, dropped_new, nits_new,
            num_active_new)


def _sharded_khosla_chunk_shardmap(
    row_cols, row_vals, row_mask, col_persons, col_mask,
    prices, p2o, o2p, dropped, nits, eps, threshold, chunk, group=None,
):
    """This rank's chunk of ``chunk`` rounds (the body of JAX's
    ``shard_map`` program): the active count (1 sum), then the rounds.
    Returns ``(prices, p2o, o2p, dropped, nits, num_active)``."""
    num_active = all_reduce(
        ((p2o == _INT_MAX) & ~dropped).sum().to(torch.int32), "sum", group
    )
    state = (prices, p2o, o2p, dropped, nits, num_active)
    for _ in range(chunk):
        state = _round_body(row_cols, row_vals, row_mask, col_persons,
                            col_mask, eps, threshold, state, group)
    return state


class _KhoslaShard(NamedTuple):
    prices: torch.Tensor   # [M/D]
    p2o: torch.Tensor      # [N/D] int32
    o2p: torch.Tensor      # [M/D] int32
    dropped: torch.Tensor  # [N/D] bool
    nits: torch.Tensor     # 0-dim int32


def _khosla_graph_chunk(shards, state, eps, threshold, group, chunk):
    out = _sharded_khosla_chunk_shardmap(*shards.arrays, *state, eps,
                                         threshold, chunk, group)
    return _KhoslaShard(*out[:5]), out[5]


def sharded_khosla_core(group=None, chunk: int = 16):
    """The chunk program over ``group``: a function of this rank's
    shards and the solve state that runs ``chunk`` rounds; the host
    loops it until no bidder is active."""
    return functools.partial(_sharded_khosla_chunk_shardmap, chunk=chunk,
                             group=group)


def solve_sharded_khosla(
    solver,
    group=None,
    eps: float | None = None,
    maximize: bool = False,
    max_rounds: int = 10_000_000,
    device=None,
):
    """Solve ``solver``'s current instance sharded over ``group``.

    Applies the reference lifecycle (sign flip, defaults, threshold,
    ``ksparse.rs:153-181``), pads persons and objects to multiples of
    the world size (padding persons start dropped, so they never bid),
    and returns ``(solution, nits)`` with the padding stripped;
    ``solver.prices`` holds the final prices."""
    dev = rank_device(group, device)
    idx, d = shard_index(group)
    solution = AuctionSolution.new()
    solver.validate_input()
    solver.init_solve(solution, maximize)

    num_cols_f = float(solver.num_cols)
    eps = float(eps) if eps is not None else 1.0 / num_cols_f
    values = solver.values
    w_min, w_max = float(values.min()), float(values.max())
    threshold = (num_cols_f / 2.0) * (w_max - w_min + eps)

    arrays, n_pad, m_pad = _padded_shards(solver, d, idx, dev)
    shards = _Shards(arrays, dev)
    dropped_init = np.zeros(n_pad, bool)
    dropped_init[solver.num_rows:] = True  # padding persons never bid
    dtype = batch_mod._torch_dtype(solver.dtype)
    state = _KhoslaShard(
        prices=torch.zeros(m_pad // d, dtype=dtype, device=dev),
        p2o=torch.full((n_pad // d,), _INT_MAX, dtype=torch.int32,
                       device=dev),
        o2p=torch.full((m_pad // d,), _INT_MAX, dtype=torch.int32,
                       device=dev),
        dropped=_shard(dropped_init, idx, d, 0, dev),
        nits=_i32(0, dev),
    )
    scalars = ((eps, dtype), (threshold, dtype))
    active, rounds = solver.num_rows, 0
    while active > 0 and rounds < max_rounds:
        state, active_dev = graphs.run(_khosla_graph_chunk, shards, state,
                                       scalars, 16, (group,))
        active, rounds = torch.stack([active_dev, state.nits]).tolist()

    _gathered_result(solver, solution, state.p2o, state.o2p, state.prices,
                     group)
    solution.eps = eps
    return solution, int(rounds)


# ----------------------------------------------------------------------
# Sharded ε-scaling forward auction
# ----------------------------------------------------------------------
def _forward_round_body(
    row_cols, row_vals, row_mask, col_persons, col_mask, person_valid,
    target_eps, toleration, sfoe, max_iterations, price_bound, state,
    group=None,
):
    """One forward-auction round on this rank's shards, with the
    replicated ε-scaling bookkeeping (the reference's outer loop,
    ``symmetric.rs:275-332``): 6 all_gathers and 3 sums.  The scalar
    state (eps, counters, done) is computed from summed quantities only,
    so every rank carries the same values."""
    (prices_sh, p2o_sh, o2p_sh, eps, nits,
     nreductions, optimal_found, done) = state
    idx, _ = shard_index(group)
    n_local = p2o_sh.shape[0]
    m_local = prices_sh.shape[0]
    dtype = prices_sh.dtype
    neg_inf = _neg_inf(dtype, prices_sh.device)

    # ---- bidding on the local person shard ----
    prices_full = all_gather_tiled(prices_sh, group)  # [M]
    best, second, best_col, best_val = top2_profits_arrays(
        row_cols, row_vals, row_mask, prices_full
    )
    unassigned = (p2o_sh == _INT_MAX) & person_valid & ~done
    price_at_best = prices_full[best_col.long()]
    has_second = second != neg_inf
    # bid rule `symmetric.rs:378`; single-arc persons bid price+eps (the
    # Khosla guard) instead of +inf
    raw_bid = torch.where(has_second, best_val - second + eps,
                          price_at_best + eps)
    bid_l = torch.where(unassigned & (best != neg_inf), raw_bid, neg_inf)

    # ---- gather all bids; resolve conflicts on the local object shard ----
    bid_full = all_gather_tiled(bid_l, group)  # [N]
    col_full = all_gather_tiled(best_col, group)  # [N]
    max_bid, has_winner, winner_l = _resolve_objects(
        col_persons, col_mask, bid_full, col_full, m_local, idx, neg_inf
    )
    prices_new = torch.where(has_winner, max_bid.to(dtype), prices_sh)
    o2p_new = torch.where(has_winner, winner_l, o2p_sh)

    # ---- gather winners; update the local person shard ----
    winner_full = all_gather_tiled(winner_l, group)  # [M]
    has_winner_full = all_gather_tiled(has_winner, group)
    p2o_new = _update_persons(p2o_sh, bid_l != neg_inf, best_col,
                              winner_full, has_winner_full, n_local, idx)

    nits_new = nits + (~done).to(torch.int32)
    num_unassigned = all_reduce(
        ((p2o_new == _INT_MAX) & person_valid).sum().to(torch.int32),
        "sum", group,
    )
    fully = (num_unassigned == 0) & ~done

    # ---- ε-CS certificate at the updated prices (`solver.rs:154-189`,
    # sharded: per-shard violation counts, one sum) ----
    prices_upd = all_gather_tiled(prices_new, group)  # [M]
    profit_upd = torch.where(
        row_mask, row_vals - prices_upd[row_cols.long()], neg_inf
    )
    max_profit = profit_upd.amax(dim=0)
    is_chosen = row_mask & (row_cols == p2o_new[None, :])
    chosen_val = torch.where(is_chosen, row_vals, neg_inf).amax(dim=0)
    safe_j = torch.where(p2o_new != _INT_MAX, p2o_new, 0).long()
    chosen_profit = chosen_val - prices_upd[safe_j]
    viol_l = (
        person_valid
        & (chosen_profit + toleration < max_profit - target_eps)
    ).sum().to(torch.int32)
    is_optimal = sfoe | (all_reduce(viol_l, "sum", group) == 0)

    # ---- replicated ε-scaling bookkeeping (`symmetric.rs:280-328`) ----
    stop = is_optimal | (eps < target_eps)
    reduce = fully & ~stop
    eps_new = torch.where(reduce, eps * torch.tensor(0.15, dtype=dtype),
                          eps)
    # reference semantics: reset assignments, keep prices
    p2o_out = torch.where(reduce, _INT_MAX, p2o_new)
    o2p_out = torch.where(reduce, _INT_MAX, o2p_new)
    nreductions_new = nreductions + reduce.to(torch.int32)
    optimal_new = optimal_found | (fully & is_optimal)
    # infeasibility certificate: the phase-telescoped Bertsekas bound
    # of ops/auction.py:forward_solve_chunked, over the local price
    # shard and summed
    diverged = all_reduce(
        (prices_new > price_bound).sum().to(torch.int32), "sum", group
    ) > 0
    done_new = (
        done | (fully & stop) | diverged | (nits_new >= max_iterations)
    )
    trace_round(
        "sharded forward round {} shard {}: eps={} reductions={} done={}",
        nits_new, idx, eps_new, nreductions_new, done_new,
    )
    return (prices_new, p2o_out, o2p_out, eps_new, nits_new,
            nreductions_new, optimal_new, done_new)


def _sharded_forward_chunk_shardmap(
    row_cols, row_vals, row_mask, col_persons, col_mask, person_valid,
    prices, p2o, o2p, eps, nits, nreductions, optimal_found, done,
    target_eps, toleration, sfoe, max_iterations, price_bound, chunk,
    group=None,
):
    """This rank's chunk of ``chunk`` forward rounds (the body of JAX's
    ``shard_map`` program); rounds after ``done`` are no-ops."""
    state = (prices, p2o, o2p, eps, nits, nreductions, optimal_found, done)
    for _ in range(chunk):
        state = _forward_round_body(
            row_cols, row_vals, row_mask, col_persons, col_mask,
            person_valid, target_eps, toleration, sfoe, max_iterations,
            price_bound, state, group,
        )
    return state


class _ForwardShard(NamedTuple):
    prices: torch.Tensor         # [M/D]
    p2o: torch.Tensor            # [N/D] int32
    o2p: torch.Tensor            # [M/D] int32
    eps: torch.Tensor            # 0-dim, the value dtype
    nits: torch.Tensor           # 0-dim int32
    nreductions: torch.Tensor    # 0-dim int32
    optimal_found: torch.Tensor  # 0-dim bool
    done: torch.Tensor           # 0-dim bool


def _forward_graph_chunk(shards, state, target_eps, toleration, sfoe,
                         max_iterations, price_bound, group, chunk):
    return _ForwardShard(*_sharded_forward_chunk_shardmap(
        *shards.arrays, *state, target_eps, toleration, sfoe,
        max_iterations, price_bound, chunk, group,
    ))


def sharded_forward_core(group=None, chunk: int = 16):
    """The forward-auction chunk program over ``group``."""
    return functools.partial(_sharded_forward_chunk_shardmap, chunk=chunk,
                             group=group)


def solve_sharded_forward(
    solver,
    group=None,
    eps: float | None = None,
    maximize: bool = False,
    start_eps: float | None = None,
    max_iterations: int = 100_000,
    device=None,
):
    """Solve ``solver``'s current instance with the ε-scaling forward
    auction sharded over ``group``.

    Semantics of the single-device chunked solver (``symmetric.py``):
    target eps defaults to ``1/num_rows`` (``symmetric.rs:231-235``),
    start eps to ``C/2`` on symmetric instances, asymmetric instances
    disable scaling (``symmetric.rs:256-267``), ``max_iterations`` and
    the price bound cut off infeasible instances.  Returns
    ``(solution, nits)``; the solver's ``nreductions``,
    ``optimal_soln_found`` and ``nits`` are set where it has them."""
    dev = rank_device(group, device)
    idx, d = shard_index(group)
    solution = AuctionSolution.new()
    solver.validate_input()
    solver.init_solve(solution, maximize)

    target_eps = (
        float(eps) if eps is not None else 1.0 / float(solver.num_rows)
    )
    values = solver.values
    c = float(np.abs(values).max()) if values.size else 0.0
    toleration = solver.get_toleration(c)
    sfoe = start_eps is not None and start_eps < target_eps
    if solver.num_rows != solver.num_cols:
        sfoe = True
        eps0 = target_eps - float(np.finfo(np.float64).eps)
    else:
        eps0 = float(start_eps) if start_eps is not None else c / 2.0

    arrays, n_pad, m_pad = _padded_shards(solver, d, idx, dev)
    person_valid = np.zeros(n_pad, bool)
    person_valid[: solver.num_rows] = True
    shards = _Shards(arrays + [_shard(person_valid, idx, d, 0, dev)], dev)
    dtype = batch_mod._torch_dtype(solver.dtype)
    state = _ForwardShard(
        prices=torch.zeros(m_pad // d, dtype=dtype, device=dev),
        p2o=torch.full((n_pad // d,), _INT_MAX, dtype=torch.int32,
                       device=dev),
        o2p=torch.full((m_pad // d,), _INT_MAX, dtype=torch.int32,
                       device=dev),
        eps=torch.tensor(eps0, dtype=dtype, device=dev),
        nits=_i32(0, dev),
        nreductions=_i32(0, dev),
        optimal_found=torch.tensor(False, device=dev),
        done=torch.tensor(False, device=dev),
    )
    # infeasibility certificate: the phase-telescoped Bertsekas bound of
    # ops/auction.py:forward_solve_chunked (start prices 0)
    eps_hi = max(eps0, target_eps)
    ratio = eps0 / max(target_eps, 1e-300)
    phases = (
        1 if ratio <= 1.0
        else int(np.ceil(np.log2(max(ratio, 2.0)))) + 1
    )
    bound = (phases + 1) * (2 * solver.num_rows + 1) * (c + eps_hi) + 1.0
    scalars = ((target_eps, dtype), (toleration, dtype), (sfoe, torch.bool),
               (max_iterations, torch.int32), (bound, dtype))
    while not bool(state.done):
        state = graphs.run(_forward_graph_chunk, shards, state, scalars,
                           16, (group,))

    _gathered_result(solver, solution, state.p2o, state.o2p, state.prices,
                     group)
    solution.eps = float(state.eps)
    nits = int(state.nits)
    if hasattr(solver, "nreductions"):
        solver.nreductions = int(state.nreductions)
    if hasattr(solver, "optimal_soln_found"):
        solver.optimal_soln_found = bool(state.optimal_found)
    if hasattr(solver, "nits"):
        solver.nits = nits
    return solution, nits


# ----------------------------------------------------------------------
# Sharded single-instance dense forward-reverse auction
# ----------------------------------------------------------------------
def _merge_top2_sharded(group, lbest, lsecond, larg):
    """Merge rank-local per-person top-2 results into the global
    ``(best, second, arg)``: 2 max and 2 min.  Ranks hold contiguous
    ascending object rows, so taking the smallest rank on ties (then
    that rank's own smallest-row arg) is the single-device
    smallest-row rule."""
    idx, d = shard_index(group)
    dev = lbest.device
    gbest = all_reduce(lbest, "max", group)  # [N]
    dstar = all_reduce(
        torch.where(lbest == gbest, _i32(idx, dev), _i32(d, dev)), "min",
        group,
    )
    mine = dstar == idx
    # the selected rank contributes its second; every other rank's best
    # is a second-place candidate (equal maxima land here too)
    gsecond = all_reduce(torch.where(mine, lsecond, lbest), "max", group)
    garg = all_reduce(torch.where(mine, larg, _INT_MAX), "min", group)
    return gbest, gsecond, garg


def _merge_max_sharded(group, lmax, larg):
    """Merge rank-local per-person ``(max, argmin-row)`` pairs: 1 max
    and 2 min."""
    idx, d = shard_index(group)
    dev = lmax.device
    gmax = all_reduce(lmax, "max", group)
    dstar = all_reduce(
        torch.where(lmax == gmax, _i32(idx, dev), _i32(d, dev)), "min",
        group,
    )
    garg = all_reduce(torch.where(dstar == idx, larg, _INT_MAX), "min",
                      group)
    return gmax, garg


def _fr_round_sharded(vals_l, state, forward: bool, group=None):
    """One forward-reverse round of an instance that is not done, with
    the object dimension sharded.

    ``vals_l [M/D, N]`` is this rank's row slice; prices and o2p are
    sharded with it; pi, p2o and the scalars are replicated.  The math
    is ``ops/fr_dense.fr_round(skip_certificate=True)``'s, in the JAX
    module's order.  ``forward`` is the replicated mode, read by the
    host: the round runs that sub-round only, as ``lax.cond`` does."""
    (prices_l, o2p_l, pi, p2o, forward_mode, done, nits, since,
     stall_k, eps) = state
    idx, _ = shard_index(group)
    ml, n = vals_l.shape
    dev = vals_l.device
    neg_inf = _neg_inf(vals_l.dtype, dev)
    card_old = (p2o != _INT_MAX).sum()
    r_local = torch.arange(ml, dtype=torch.int32, device=dev)[:, None]
    u_iota = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    r_global = r_local + idx * ml

    if forward:
        profit = vals_l - prices_l[:, None]
        lbest = profit.amax(dim=0)                             # [N]
        lr = torch.where(profit == lbest[None, :], r_local, ml).amin(dim=0)
        lsel = r_local == lr[None, :]
        lsecond = torch.where(lsel, neg_inf, profit).amax(dim=0)
        best, second, best_j = _merge_top2_sharded(
            group, lbest, lsecond, lr + idx * ml
        )
        floor = torch.where(second != neg_inf, second, best)
        bidding = (p2o == _INT_MAX) & (best != neg_inf)
        inc = torch.where(bidding, best - floor + eps, neg_inf)

        local_j = best_j - idx * ml                            # [N]
        is_here = (local_j[None, :] == r_local) & (inc[None, :] != neg_inf)
        eff = torch.where(is_here, inc[None, :], neg_inf)
        max_inc = eff.amax(dim=1)                              # [M/D]
        has_winner = max_inc != neg_inf
        cand = torch.where(is_here & (eff >= max_inc[:, None]), u_iota,
                           _INT_MAX)
        winner = cand.amin(dim=1)
        prices_l = torch.where(has_winner, prices_l + max_inc, prices_l)
        o2p_l = torch.where(has_winner, winner, o2p_l)

        t_won = is_here & (winner[:, None] == u_iota)
        t_disp = (p2o[None, :] == r_global) & has_winner[:, None]
        code = all_reduce(
            (t_won.to(torch.float32)
             + 2.0 * t_disp.to(torch.float32)).sum(dim=0),
            "sum", group,
        )                                                      # [N]
        won = (code == 1.0) | (code == 3.0)
        displaced = (p2o != _INT_MAX) & (code >= 2.0)
        p2o = torch.where(won, best_j,
                          torch.where(displaced, _INT_MAX, p2o))
        pi = torch.where(won, (floor - eps).to(pi.dtype), pi)
    else:
        rprof = vals_l - pi[None, :]
        beta = rprof.amax(dim=1)                               # [M/D]
        best_i = torch.where(rprof == beta[:, None], u_iota,
                             n).amin(dim=1)
        rsel = u_iota == best_i[:, None]
        gamma = torch.where(rsel, neg_inf, rprof).amax(dim=1)
        rfloor = torch.where(gamma != neg_inf, gamma, beta)
        pi_inc = beta - rfloor + eps

        bidding = (o2p_l == _INT_MAX) & (beta != neg_inf)
        rinc = torch.where(bidding, pi_inc, neg_inf)
        is_here = rsel & bidding[:, None]
        eff = torch.where(is_here, rinc[:, None], neg_inf)
        lmax = eff.amax(dim=0)                                 # [N]
        larg = torch.where(is_here & (eff >= lmax[None, :]), r_global,
                           _INT_MAX).amin(dim=0)
        max_inc, winner_obj = _merge_max_sharded(group, lmax, larg)
        has_rw = max_inc != neg_inf

        t_won = is_here & (winner_obj[None, :] == r_global)
        is_disp = has_rw & (p2o != _INT_MAX)
        t_freed = (p2o[None, :] == r_global) & is_disp[None, :]
        code = (t_won.to(torch.float32)
                + 2.0 * t_freed.to(torch.float32)).sum(dim=1)  # [M/D]
        won_obj = (code == 1.0) | (code == 3.0)
        freed = code >= 2.0
        prices_l = torch.where(won_obj, (rfloor - eps).to(prices_l.dtype),
                               prices_l)
        o2p_l = torch.where(won_obj, best_i,
                            torch.where(freed, _INT_MAX, o2p_l))
        pi = torch.where(has_rw, pi + max_inc.to(pi.dtype), pi)
        p2o = torch.where(has_rw, winner_obj, p2o)

    card_new = (p2o != _INT_MAX).sum()
    increased = card_new > card_old
    stall_flip = ~increased & (since + 1 >= stall_k)
    forward_mode = forward_mode ^ (increased | stall_flip)
    since = torch.where(increased | stall_flip, 0, since + 1)
    stall_k = torch.where(increased, _STALL_K0,
                          torch.where(stall_flip, stall_k * 2, stall_k))
    nits = nits + 1
    done = done | (card_new == p2o.shape[0])
    trace_round(
        "sharded fr round {} shard {}: matched={} forward={} done={}",
        nits, idx, card_new, forward_mode, done,
    )
    return (prices_l, o2p_l, pi, p2o, forward_mode, done, nits, since,
            stall_k, eps)


def _fr_dense_chunk_shardmap(
    vals_l, prices, o2p, pi, p2o, forward_mode, done, nits, since,
    stall_k, eps, chunk, group=None,
):
    """This rank's chunk of up to ``chunk`` rounds.  Before each round
    the host reads the replicated mode and done flag (one readback): a
    done instance's rounds are no-ops in JAX's chunk, so the chunk ends
    there."""
    state = (prices, o2p, pi, p2o, forward_mode, done, nits, since,
             stall_k, eps)
    for _ in range(chunk):
        forward, finished = torch.stack([forward_mode, done]).tolist()
        if finished:
            break
        state = _fr_round_sharded(vals_l, state, forward, group)
        forward_mode, done = state[4], state[5]
    return state


def sharded_fr_dense_core(group=None, chunk: int = 64):
    """The chunk program of one dense instance with the object dimension
    sharded over ``group``."""
    return functools.partial(_fr_dense_chunk_shardmap, chunk=chunk,
                             group=group)


def solve_fr_dense_sharded(
    costs,
    group=None,
    maximize: bool = False,
    eps: float | None = None,
    dtype=np.float32,
    max_iterations: int = 1_000_000,
    chunk: int = 64,
    device=None,
):
    """Solve one dense square instance ``costs[N, N]`` with the
    forward-reverse auction, objects sharded over ``group``.

    The multi-device form of the big-single dense path: each rank owns a
    contiguous slice of object rows; a round's only cross-rank traffic
    is max/min reductions of ``[N]`` vectors (the top-2 and winner
    merges) and one sum of the coded won/displaced vector.  No
    ε-ladder (start ε == target ε, default ``1/(N+1)``), so a full
    assignment is the certificate.  Returns ``(p2o, o2p,
    num_unassigned, nits, objective)``."""
    costs = np.asarray(costs)
    n, m = costs.shape
    if n != m:
        raise ValueError("solve_fr_dense_sharded requires a square instance")
    dev = rank_device(group, device)
    idx, d = shard_index(group)
    work = costs if maximize else -costs
    vals_t = np.swapaxes(work.astype(dtype), 0, 1)  # [M, N]
    m_pad = ((m + d - 1) // d) * d
    if m_pad != m:
        # padded object rows have -inf value: they never win a bid and
        # never bid in reverse (beta = -inf)
        vals_t = np.concatenate(
            [vals_t, np.full((m_pad - m, n), -np.inf, dtype)], axis=0
        )
    np_dtype = np.dtype(dtype)
    tdtype = batch_mod._torch_dtype(np_dtype)
    target_eps = np_dtype.type(
        float(eps) if eps is not None else 1.0 / (n + 1)
    )
    ml = m_pad // d
    vals_l = _shard(vals_t, idx, d, 0, dev)
    state = (
        torch.zeros(ml, dtype=tdtype, device=dev),               # prices
        torch.full((ml,), _INT_MAX, dtype=torch.int32, device=dev),  # o2p
        torch.from_numpy(np.max(vals_t, axis=0).astype(np_dtype)).to(dev),
        torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev),  # p2o
        torch.tensor(True, device=dev),                           # forward
        torch.tensor(False, device=dev),                          # done
        _i32(0, dev), _i32(0, dev), _i32(_STALL_K0, dev),         # nits..
        torch.tensor(target_eps, dtype=tdtype, device=dev),
    )
    core = sharded_fr_dense_core(group, chunk)
    rounds = 0
    while True:
        state = core(vals_l, *state)
        rounds += chunk
        if bool(state[5]) or rounds >= max_iterations:
            break

    (o2p,) = all_gather_parts([state[1]], group)
    p2o_h = state[3].cpu().numpy()
    o2p_h = o2p.cpu().numpy()[:m]
    assigned = p2o_h != UNASSIGNED
    safe = np.where(assigned, p2o_h, 0)
    objective = float(
        np.where(assigned, costs[np.arange(n), safe], 0.0).sum()
    )
    num_unassigned = int((~assigned).sum())
    return p2o_h, o2p_h, num_unassigned, int(state[6]), objective


# ----------------------------------------------------------------------
# Sharded batched solve (data parallelism over independent instances)
# ----------------------------------------------------------------------
def _fr_batch_chunk_local(values_t, states, max_iterations, chunk: int,
                          use_kernel: bool, sched: int | None = None,
                          values=None, group=None):
    """This rank's chunk of forward-reverse rounds over its batch slice
    (instances are independent: the only collective is the all-done
    count, 1 sum).  ``use_kernel`` runs the FR kernel
    (``ops/fr_kernel.fr_chunk``, its plain version on CPU tensors) for
    ``sched`` rounds if given, else ``chunk``; otherwise ``chunk``
    lockstep plain rounds.  ``values`` is the person-major layout the
    kernel reads beside ``values_t``.  The FR engine starts at its
    target ε (no ladder), so the target is the states' own ``eps``."""
    if use_kernel:
        states, _ = fr_chunk(values_t, states,
                             sched if sched is not None else chunk,
                             values=values)
    else:
        states = batch_mod._batch_chunk_fr(values_t, states,
                                           max_iterations, chunk)
    local_undone = (~states.done).sum().to(torch.int32)
    return states, all_reduce(local_undone, "sum", group)


def sharded_fr_batch_core(group=None, chunk: int = 64,
                          use_kernel: bool = False,
                          sched: int | None = None):
    """The batched forward-reverse chunk program over ``group``: the
    batch dimension is sharded, everything else is local, and the
    all-done count is the only cross-rank traffic."""
    return functools.partial(_fr_batch_chunk_local, chunk=chunk,
                             use_kernel=use_kernel, sched=sched,
                             group=group)


def _local_rows(b: int, b_pad: int, idx: int, d: int) -> np.ndarray:
    """This rank's instances of the batch padded to ``b_pad`` with
    copies of instance 0."""
    rows = np.arange(idx * (b_pad // d), (idx + 1) * (b_pad // d))
    return np.where(rows < b, rows, 0)


def _local_costs(costs_dev, rows, dev) -> torch.Tensor:
    """This rank's instances ``rows`` of the full cost tensor on ``dev``
    (the tensor itself when they are all of it, in order, already
    there)."""
    if (costs_dev.device == dev and len(rows) == costs_dev.shape[0]
            and np.array_equal(rows, np.arange(len(rows)))):
        return costs_dev
    return costs_dev[torch.from_numpy(rows).to(costs_dev.device)].to(dev)


def _stage_values_t_sharded(local, negate: bool, scale: int = 0,
                            dtype=None):
    """Stage this rank's cost slice ``local`` as ``batch._stage`` does:
    sign-adjusted ``values_t [b, M, N]`` and the person-major ``work``.
    ``scale`` != 0 lifts integral costs onto the scaled-int32 lattice;
    otherwise the costs are cast to ``dtype``."""
    if not scale:
        local = local.to(dtype)
    return batch_mod._stage(local, negate, scale or None)


def _use_fr_kernel(dtype, n: int, m: int) -> bool:
    """The JAX package's kernel routing of the batch-sharded FR modes:
    float32 or the int32 lattice, N % 128 == 0, M % 8 == 0,
    N·M <= 1024²."""
    return bool(
        np.dtype(dtype) in (np.float32, np.int32)
        and n % 128 == 0
        and m % 8 == 0
        and n * m <= batch_mod._FUSED_MAX_ELEMS
    )


def solve_batch_sharded(
    costs,
    group=None,
    maximize: bool = False,
    eps: float | None = None,
    dtype=np.float32,
    max_iterations: int = 100_000,
    chunk: int = 64,
    costs_device=None,
    integer: bool | None = None,
    max_cost: float | None = None,
    device=None,
):
    """Solve a batch of dense square LAP instances ``costs[B, N, N]``
    sharded over ``group`` (forward-reverse engine, no ε-ladder).

    Pure data parallelism: instances never communicate; each rank runs
    its slice of the batch, padded to a multiple of the world size with
    copies of instance 0 (their results are dropped), on the FR kernel
    within its contract (the single-device fast path's one deep chunk,
    then 128-round continuation chunks), else on the plain rounds.
    ``costs_device`` optionally supplies a tensor with the same contents
    (each rank copies its slice from it).  ``integer``/``max_cost``: the
    integer-auction mode of ``batch.solve_batch`` (scaled-int32
    lattice; auto-detected on integral costs, ``integer=False`` opts
    out).  Returns a :class:`~..batch.BatchSolution`."""
    costs = np.asarray(costs)
    b, n, m = costs.shape
    if n != m:
        raise ValueError("solve_batch_sharded requires square instances")
    dev = rank_device(group, device)
    idx, d = shard_index(group)
    b_pad = ((b + d - 1) // d) * d
    rows = _local_rows(b, b_pad, idx, d)

    int_scale = batch_mod._integer_scale(costs, eps, n, m, integer,
                                         max_cost)
    if int_scale is not None:
        dtype = np.int32
        target_eps = np.int32(1)
    else:
        target_eps = np.dtype(dtype).type(
            float(eps) if eps is not None else 1.0 / n
        )
    if costs_device is None:
        local = torch.from_numpy(costs[rows]).to(dev)
    else:
        local = _local_costs(torch.as_tensor(costs_device), rows, dev)
    values_t, work = _stage_values_t_sharded(
        local, not maximize, int_scale or 0, batch_mod._torch_dtype(dtype))
    states = fr_init(values_t, target_eps)

    use_kernel = _use_fr_kernel(dtype, n, m)
    maxit = int(max_iterations)
    if use_kernel:
        # the one-dispatch protocol of the single-device fast path: the
        # deep round budget in ONE chunk, then rare extra chunks
        sched = batch_mod._fr_fused_schedule(b_pad // d, n, maxit)
        chunk = 128
        states, undone = _fr_batch_chunk_local(
            values_t, states, maxit, chunk, True, sched, values=work,
            group=group)
        rounds = sched
    else:
        work = None  # the plain rounds read values_t only
        states, undone = _fr_batch_chunk_local(
            values_t, states, maxit, chunk, False, group=group)
        rounds = chunk
    core = sharded_fr_batch_core(group, chunk, use_kernel)
    while int(undone) != 0 and rounds < max_iterations:
        states, undone = core(values_t, states, maxit, values=work)
        rounds += chunk

    # each person's chosen cost in the caller's units, summed on the host
    # in float64 as JAX sums them.  JAX picks from the host costs; the
    # pick is made on the device (a pick from the host costs reads a
    # far-apart row for every person) only where the tensor there holds
    # them at their precision or more
    safe = torch.where(states.p2o != _INT_MAX, states.p2o, 0).long()
    if local.dtype in (torch.float64, batch_mod._torch_dtype(costs.dtype)):
        picked = local.gather(2, safe[:, :, None])[:, :, 0].to(
            torch.float64)
        p2o, nits, picked = (x.cpu().numpy()[:b] for x in all_gather_parts(
            [states.p2o, states.nits, picked], group))
    else:
        p2o, nits = (x.cpu().numpy()[:b] for x in all_gather_parts(
            [states.p2o, states.nits], group))
        picked = np.take_along_axis(
            costs.astype(np.float64),
            np.where(p2o != UNASSIGNED, p2o, 0)[:, :, None], axis=2,
        )[:, :, 0]
    assigned = p2o != UNASSIGNED
    objective = np.where(assigned, picked, 0.0).sum(axis=1)
    return batch_mod.BatchSolution(
        person_to_object=p2o,
        object_to_person=o2p_from_p2o(p2o, m),
        num_unassigned=(~assigned).sum(axis=1).astype(np.int32),
        objective=objective,
        # lattice ε = 1 is 1/scale in original cost units
        eps=np.full(
            b,
            1.0 / int_scale if int_scale is not None else float(target_eps),
        ),
        nits=nits,
    )


def solve_batch_sharded_stream(
    device_batches,
    group=None,
    maximize: bool = False,
    eps: float | None = None,
    dtype=np.float32,
    max_iterations: int = 100_000,
    integer: bool | None = None,
    max_cost: float | None = None,
    window: int = 2,
    device=None,
):
    """Pipelined batched solves over ``group``: ``batch.
    solve_batch_stream`` with the batch dimension sharded.

    ``device_batches`` is a sequence of ``[B, N, N]`` cost tensors of
    one shape (every rank passes the same ones; each copies its slice to
    its device).  Each batch runs the per-rank schedule of
    :func:`solve_batch_sharded` (on the FR kernel: one deep chunk, no
    collective until the readback); up to ``window`` batches are in
    flight, each on its own CUDA stream on the card, so the gathered
    readback of batch *i* overlaps the ranks' rounds of batch *i+1*.
    The objective is evaluated on the device (original units); results
    come back in input order as ``list[BatchSolution]``.  Off the
    kernel's contract each batch runs lockstep plain chunks with a
    done count a chunk."""
    device_batches = list(device_batches)
    if not device_batches:
        return []
    b, n, m = device_batches[0].shape
    for x in device_batches[1:]:
        if tuple(x.shape) != (b, n, m):
            raise ValueError("all batches must share one shape")
    if n != m:
        raise ValueError(
            "solve_batch_sharded_stream requires square instances"
        )
    dev = rank_device(group, device)
    idx, d = shard_index(group)
    b_pad = ((b + d - 1) // d) * d
    rows = _local_rows(b, b_pad, idx, d)

    int_scale = batch_mod._integer_scale(None, eps, n, m, integer, max_cost)
    if int_scale is not None:
        dtype = np.int32
        target_eps = np.int32(1)
        out_eps = 1.0 / int_scale
    else:
        target_eps = np.dtype(dtype).type(
            float(eps) if eps is not None else 1.0 / n
        )
        out_eps = float(target_eps)
    tdtype = batch_mod._torch_dtype(dtype)
    negate = not maximize
    use_kernel = _use_fr_kernel(dtype, n, m)
    chunk = 128
    maxit = int(max_iterations)
    core = sharded_fr_batch_core(group, chunk, use_kernel)
    sched = batch_mod._fr_fused_schedule(b_pad // d, n, maxit)
    window = max(1, window)
    streams = batch_mod._window_streams(dev, window)

    def dispatch(x, stream):
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with batch_mod._on_stream(stream):
            vt, work = _stage_values_t_sharded(
                _local_costs(torch.as_tensor(x), rows, dev), negate,
                int_scale or 0, tdtype)
            st = fr_init(vt, target_eps)
            if use_kernel:
                st, _ = fr_chunk(vt, st, sched, values=work)
                rounds = sched
            else:
                st, undone = core(vt, st, maxit)
                rounds = chunk
                while int(undone) != 0 and rounds < max_iterations:
                    st, undone = core(vt, st, maxit)
                    rounds += chunk
        return stream, vt, work, st, rounds

    def finish(stream, vt, work, st, rounds):
        with batch_mod._on_stream(stream):
            while True:
                objective = batch_mod._device_objective(work, st.p2o,
                                                        negate)
                p2o, nits, done, objective = (
                    x.cpu().numpy()[:b] for x in all_gather_parts(
                        [st.p2o, st.nits, st.done, objective], group))
                undone = int((~done).sum())
                trace_host("fr sharded stream: rounds={} undone={}/{}",
                           rounds, undone, b)
                if undone == 0 or rounds >= max_iterations:
                    break
                st, _ = core(vt, st, maxit, values=work)
                rounds += chunk
        if int_scale is not None:
            objective = objective / int_scale
        return batch_mod.BatchSolution(
            person_to_object=p2o,
            object_to_person=o2p_from_p2o(p2o, m),
            num_unassigned=(p2o == UNASSIGNED).sum(axis=1).astype(
                np.int32),
            objective=objective,
            eps=np.full(b, out_eps),
            nits=nits,
        )

    results: list = []
    pending: deque = deque()
    for k, x in enumerate(device_batches):
        pending.append(dispatch(x, streams[k % window]))
        # drain at window: at most `window` staged batches are live, and
        # the oldest batch's readback overlaps the newer ones' rounds
        while len(pending) >= window:
            results.append(finish(*pending.popleft()))
    while pending:
        results.append(finish(*pending.popleft()))
    return results


# ----------------------------------------------------------------------
# Sharded batched sparse solve (Khosla kernel on each rank's slice)
# ----------------------------------------------------------------------
def _ksp_batch_local(columns_l, values_l, valid_l, eps_s, *, m: int,
                     rounds: int, negate: bool):
    """This rank's batched-sparse program: the device scatter staging,
    the state (batch-padding slots born all-dropped), ``rounds`` rounds
    of the Khosla kernel (``ops/ksparse_kernel.ksp_chunk``, its plain
    version on CPU tensors) and the objective in original cost units,
    summed in float64.  No collective.  Returns ``(p2o [b, N], active
    [b] bool, nits [b], objective [b])``."""
    plane, w_lo, w_hi = batch_mod._sparse_stage_scatter(
        columns_l, values_l, m, negate
    )
    thresholds = (m / 2.0) * (w_hi - w_lo + eps_s)
    states = khosla_init(plane)
    states = states._replace(dropped=states.dropped | ~valid_l[:, None])
    states = ksp_chunk(plane, states, eps_s, thresholds, rounds)
    active = ((states.p2o == _INT_MAX) & ~states.dropped).any(dim=1)
    # p2o is in original column space (no compaction): the match picks
    # the original arc values
    match = (columns_l == states.p2o[:, :, None]) & (columns_l >= 0)
    objective = torch.where(match, values_l.to(torch.float64), 0.0).sum(
        dim=(1, 2))
    return states.p2o, active, states.nits, objective


def sharded_ksp_batch_core(group=None, m: int = 128, rounds: int = 64,
                           negate: bool = True):
    """The batched-sparse program over ``group``: each rank runs the
    Khosla kernel on its slice of the batch, with no cross-rank traffic
    until the gathered result."""
    del group  # the program is rank-local; the caller gathers
    return functools.partial(_ksp_batch_local, m=m, rounds=rounds,
                             negate=negate)


def solve_batch_sparse_sharded(
    columns,
    values,
    num_cols: int,
    group=None,
    maximize: bool = False,
    eps: float | None = None,
    max_rounds: int = 10_000_000,
    device=None,
):
    """Batched k-sparse Khosla solve, ``columns[B, N, K]`` (int32, −1
    pads) / ``values[B, N, K]`` (float32) sharded over ``group``'s
    ranks, each running the Khosla kernel on its slice
    (``batch.solve_batch_sparse``'s dense engine, batch-sharded).
    Requires N % 8 == 0 and num_cols % 128 == 0 (the JAX kernel's shape
    contract).  The batch is padded to a multiple of the world size with
    copies of instance 0, born all-dropped.  Deterministic: results are
    bit-identical across world sizes.  An instance still active after
    the round budget is solved again from scratch with 4x the budget
    (the program is stateless), as in the JAX package."""
    columns = np.asarray(columns, np.int32)
    values = np.asarray(values, np.float32)
    b, n, k = columns.shape
    m = int(num_cols)
    if n % 8 or m % 128:
        raise ValueError(
            f"sharded batch-sparse needs N%8==0 and num_cols%128==0, "
            f"got {n}x{m}"
        )
    if n > m:
        raise ValueError("num_rows must be <= num_cols")
    if not (columns >= 0).any(axis=2).all():
        raise ValueError("every person needs at least one arc")
    if columns.max() >= m:
        raise ValueError(f"column ids must be below num_cols ({m})")
    dev = rank_device(group, device)
    idx, d = shard_index(group)
    b_pad = ((b + d - 1) // d) * d
    rows = _local_rows(b, b_pad, idx, d)
    valid_l = torch.from_numpy(
        np.arange(idx * (b_pad // d), (idx + 1) * (b_pad // d)) < b
    ).to(dev)
    columns_l = torch.from_numpy(columns[rows]).to(dev)
    values_l = torch.from_numpy(values[rows]).to(dev)
    eps_val = float(eps) if eps is not None else 1.0 / m
    eps_s = torch.tensor(eps_val, dtype=torch.float32, device=dev)

    budget = batch_mod._SPARSE_KERNEL_BUDGET
    while True:
        core = sharded_ksp_batch_core(group, m, budget, not maximize)
        p2o, active, nits, objective = (
            x.cpu().numpy()[:b] for x in all_gather_parts(
                list(core(columns_l, values_l, valid_l, eps_s)), group))
        if not active.any() or budget >= max_rounds:
            break
        # rare at m >> n: the program is stateless, so the continuation
        # solves again from scratch with a 4x budget
        budget = min(max_rounds, budget * 4)
    assigned = p2o != UNASSIGNED
    return batch_mod.BatchSolution(
        person_to_object=p2o,
        object_to_person=o2p_from_p2o(p2o, m),
        num_unassigned=(~assigned).sum(axis=1).astype(np.int32),
        objective=objective,
        eps=np.full(b, eps_val),
        nits=nits,
    )
