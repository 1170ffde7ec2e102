"""Slot-list Khosla rounds: an endgame whose cost follows the active set.

The port of the JAX package's ``ops/compact.py``, plain PyTorch as it
is plain XLA there.  The synchronous round of ``ops/auction.py`` touches
every person and object; an auction's endgame is displacement chains,
one or two bidders walking the graph while everyone else is settled.
The active set is closed under the auction: a round can only activate
the previous owner of an object just won, and that owner takes the
winner's place.  So the active set rides in the state as a fixed-size
slot list:

- slot i holds an unassigned person id (or EMPTY = INT32_MAX);
- when slot i's person wins object v, the slot takes v's previous owner
  (EMPTY precisely when v was free);
- losers keep their slot; persons dropped by the price threshold leave.

A round costs O(K P) gathers and P-element scatters; the host re-packs
the list into smaller levels as the auction drains.  While most persons
are active, ``_full_round`` (every person, the degree-split layout)
runs instead; both rounds evolve the state bit-identically.

Conflicts resolve by a scatter-max of the bids into the prices and a
scatter-min of the winners' ids (the smallest person among equal bids),
``scatter_reduce_`` with ``include_self``: order-independent on the
CPU and on CUDA.  Writes that might collide go to a dump slot past the
end that is cut off; real indices are unique.  Device state stays int32;
indices widen to int64 only as gather and scatter arguments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..solution import UNASSIGNED
from ..utils.trace import is_enabled, trace_host, trace_round
from . import graphs
from .auction import _neg_inf, top2_profits_arrays
from .padded import PaddedProblem, numpy_dtype, problem_on
from .prefix import compact_indices

_INT_MAX = UNASSIGNED


class LState(NamedTuple):
    prices: torch.Tensor   # [M]
    p2o: torch.Tensor      # [N] int32
    o2p: torch.Tensor      # [M] int32
    dropped: torch.Tensor  # [N] bool
    slots: torch.Tensor    # [P] int32 active person ids, EMPTY = INT32_MAX
    nits: torch.Tensor     # () int32


def fresh_lstate(prices: torch.Tensor, n: int) -> LState:
    """A phase's start from its prices: nobody assigned or dropped,
    every person in a slot."""
    m, dev = prices.shape[0], prices.device
    return LState(
        prices=prices,
        p2o=torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev),
        o2p=torch.full((m,), _INT_MAX, dtype=torch.int32, device=dev),
        dropped=torch.zeros(n, dtype=torch.bool, device=dev),
        slots=torch.arange(n, dtype=torch.int32, device=dev),
        nits=torch.zeros((), dtype=torch.int32, device=dev),
    )


def lstate_from_jax(np_fields: dict, device=None) -> LState:
    """An :class:`LState` from the JAX package's ``LState`` fields given
    as NumPy arrays keyed by field name.  ``device=None`` means
    ``"cuda"``."""
    dev = resolve_device(device)
    out = {}
    for name in LState._fields:
        arr = np.array(np_fields[name])
        if name in ("p2o", "o2p", "slots", "nits"):
            arr = arr.astype(np.int32)
        elif name == "dropped":
            arr = arr.astype(bool)
        out[name] = torch.from_numpy(arr).to(dev)
    return LState(**out)


def lstate_to_numpy(state: LState) -> dict:
    """The inverse of :func:`lstate_from_jax`."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in LState._fields}


def _full_top2(problem: PaddedProblem, prices):
    """Top-2 of every person, through the degree split when present:
    the first 8 slots of everyone, then the overflow slots of the few
    persons with more, merged (base slots come first in row order, so a
    tie keeps the base slot)."""
    if problem.row_cols8 is None:
        return top2_profits_arrays(problem.row_cols, problem.row_vals,
                                   problem.row_mask, prices)
    b_best, b_second, b_col, b_val = top2_profits_arrays(
        problem.row_cols8, problem.row_vals8, problem.row_mask8, prices)
    o_best, o_second, o_col, o_val = top2_profits_arrays(
        problem.ovf_cols, problem.ovf_vals, problem.ovf_mask, prices)
    ids = problem.ovf_person.long()
    b1 = b_best[ids]
    s1 = b_second[ids]
    take_o = o_best > b1
    best_m = torch.where(take_o, o_best, b1)
    second_m = torch.where(take_o, torch.maximum(b1, o_second),
                           torch.maximum(s1, o_best))
    col_m = torch.where(take_o, o_col, b_col[ids])
    val_m = torch.where(take_o, o_val, b_val[ids])
    # the overflow persons are distinct: plain index writes
    b_best = b_best.index_put((ids,), best_m)
    b_second = b_second.index_put((ids,), second_m)
    b_col = b_col.index_put((ids,), col_m)
    b_val = b_val.index_put((ids,), val_m)
    return b_best, b_second, b_col, b_val


def _bids(best, second, best_col, best_val, active, prices, eps,
          threshold):
    """The choice, drop and update rules of a round over candidates
    ``active``: ``(bidder, drop_now, bid, obj)``.  The price of the best
    object is reconstructed from the profit (``value - profit``), the
    same float in both rounds."""
    neg_inf = _neg_inf(prices.dtype, prices.device)
    zero = torch.zeros((), dtype=prices.dtype, device=prices.device)
    price_at_best = torch.where(best != neg_inf, best_val - best, zero)
    bidder0 = active & (best != neg_inf)
    drop_now = bidder0 & (price_at_best > threshold)
    bidder = bidder0 & ~drop_now
    has_second = second != neg_inf
    raw_bid = torch.where(has_second, best_val - second + eps,
                          price_at_best + eps)
    bid = torch.where(bidder, raw_bid, neg_inf)
    obj = torch.where(bidder, best_col, 0)
    return bidder, drop_now, bid, obj


def _conflicts(prices, bidder, bid, obj, ids):
    """Scatter-max of the bids into the prices, then the smallest bidder
    id among those whose bid became the price: ``(prices_new, won_bid,
    winner [M], obj64)``."""
    m = prices.shape[0]
    obj64 = obj.long()
    prices_new = prices.scatter_reduce(0, obj64, bid.to(prices.dtype),
                                       "amax", include_self=True)
    won_bid = bidder & (bid == prices_new[obj64])
    cand = torch.where(won_bid, ids, _INT_MAX)
    scat_obj = torch.where(won_bid, obj64, m)
    winner = torch.full((m + 1,), _INT_MAX, dtype=torch.int32,
                        device=prices.device)
    winner = winner.scatter_reduce(0, scat_obj, cand, "amin",
                                   include_self=True)[:m]
    return prices_new, won_bid, winner, obj64


def _full_round(problem: PaddedProblem, s: LState, eps, threshold):
    """One round over ALL unassigned persons (no slot list, no row
    gathers): the cheap form while the active set is a large share of
    N.  ``slots`` passes through stale; ``repack_slots`` rebuilds it
    before the slot-list levels."""
    n = s.p2o.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=s.p2o.device)
    active = (s.p2o == _INT_MAX) & ~s.dropped
    any_active = active.any()

    best, second, best_col, best_val = _full_top2(problem, s.prices)
    bidder, drop_now, bid, obj = _bids(best, second, best_col, best_val,
                                       active, s.prices, eps, threshold)
    prices_new, won_bid, winner, obj64 = _conflicts(s.prices, bidder, bid,
                                                    obj, ids)
    has_w = winner != _INT_MAX

    win = won_bid & (winner[obj64] == ids)
    o2p_new = torch.where(has_w, winner, s.o2p)
    assigned = s.p2o != _INT_MAX
    safe_cur = torch.where(assigned, s.p2o, 0).long()
    displaced = assigned & has_w[safe_cur]
    p2o_new = torch.where(win, obj,
                          torch.where(displaced, _INT_MAX, s.p2o))
    if is_enabled():
        trace_round("khosla full round {}: active={} dropped={}",
                    s.nits, active.sum(), drop_now.sum())
    return LState(
        prices=prices_new,
        p2o=p2o_new,
        o2p=o2p_new,
        dropped=s.dropped | drop_now,
        slots=s.slots,
        nits=s.nits + any_active.to(torch.int32),
    )


def _full_chunk(problem, state, eps, threshold, chunk):
    for _ in range(chunk):
        state = _full_round(problem, state, eps, threshold)
    active = ((state.p2o == _INT_MAX) & ~state.dropped).sum()
    return state, active.to(torch.int32)


def khosla_full_chunk(problem: PaddedProblem, state: LState, eps,
                      threshold, chunk: int):
    """``chunk`` full-scan rounds; returns ``(state, active count)``,
    the count a 0-dim int32 tensor left on the device.  On a CUDA device
    the chunk replays as a captured graph (``ops/graphs.py``)."""
    dt = problem.dtype
    return graphs.run(_full_chunk, problem, state,
                      ((eps, dt), (threshold, dt)), chunk)


def _slot_round(problem: PaddedProblem, s: LState, eps, threshold):
    """One round over the occupied slots."""
    n = s.p2o.shape[0]
    ids = s.slots
    occupied = ids != _INT_MAX
    any_active = occupied.any()
    safe_ids = torch.where(occupied, ids, 0)
    safe64 = safe_ids.long()

    rows_c = problem.row_cols_t[safe64].T            # [K, P]
    vals_c = problem.row_vals_t[safe64].T
    mask_c = problem.row_mask_t[safe64].T & occupied[None, :]
    best, second, best_col, best_val = top2_profits_arrays(
        rows_c, vals_c, mask_c, s.prices)
    bidder, drop_now, bid, obj = _bids(best, second, best_col, best_val,
                                       occupied, s.prices, eps, threshold)
    prices_new, won_bid, winner, obj64 = _conflicts(s.prices, bidder, bid,
                                                    obj, ids)
    has_w = winner != _INT_MAX

    win = won_bid & (winner[obj64] == ids)
    prev = s.o2p[obj64]  # the previous owner of the object bid on
    o2p_new = torch.where(has_w, winner, s.o2p)
    # the winner's slot takes the displaced owner (EMPTY if v was free)
    slots_new = torch.where(win, prev,
                            torch.where(drop_now, _INT_MAX, ids))

    # person-side writes go through a dump slot n that is cut off: the
    # displaced owners are distinct, so are the winners, and neither
    # set meets the other (winners were unassigned)
    disp = win & (prev != _INT_MAX)
    p2o_ext = torch.cat([s.p2o, s.p2o.new_zeros(1)])
    p2o_ext = p2o_ext.scatter(0, torch.where(disp, prev, n).long(),
                              torch.full_like(prev, _INT_MAX))
    p2o_ext = p2o_ext.scatter(0, torch.where(win, safe_ids, n).long(),
                              torch.where(win, obj, 0))
    dropped_ext = torch.cat([s.dropped, s.dropped.new_zeros(1)])
    dropped_ext = dropped_ext.scatter(
        0, torch.where(drop_now, safe_ids, n).long(),
        torch.ones_like(drop_now))
    if is_enabled():
        trace_round("khosla slot round {}: occupied={} dropped={}",
                    s.nits, occupied.sum(), drop_now.sum())
    return LState(
        prices=prices_new,
        p2o=p2o_ext[:n],
        o2p=o2p_new,
        dropped=dropped_ext[:n],
        slots=slots_new,
        nits=s.nits + any_active.to(torch.int32),
    )


def _run_chunk(problem, state, eps, threshold, chunk):
    for _ in range(chunk):
        state = _slot_round(problem, state, eps, threshold)
    return state, (state.slots != _INT_MAX).sum().to(torch.int32)


def khosla_run_chunk(problem: PaddedProblem, state: LState, eps,
                     threshold, chunk: int):
    """``chunk`` slot-list rounds; returns ``(state, occupied count)``,
    the count a 0-dim int32 tensor left on the device.  On a CUDA device
    the chunk replays as a captured graph (``ops/graphs.py``)."""
    dt = problem.dtype
    return graphs.run(_run_chunk, problem, state,
                      ((eps, dt), (threshold, dt)), chunk)


def repack_slots(state: LState, p_new: int) -> LState:
    """Re-pack the active persons into ``p_new`` slots in id order (the
    occupied count must be at most ``p_new``)."""
    mask = (state.p2o == _INT_MAX) & ~state.dropped
    ids, count = compact_indices(mask, p_new)
    iota = torch.arange(p_new, dtype=torch.int32, device=ids.device)
    return state._replace(slots=torch.where(iota < count, ids, _INT_MAX))


def _levels_for(n: int, base: int = 8):
    """Slot-list sizes: powers of 8 from ``base`` up to n, largest
    first."""
    levels = []
    p = base
    while p < n:
        levels.append(p)
        p *= 8
    levels.append(n)
    return levels[::-1]


def _poll(count: torch.Tensor, state: LState):
    """The active count and ``nits`` in one readback."""
    return torch.stack((count, state.nits)).tolist()


def khosla_solve_compact(
    problem: PaddedProblem,
    eps: float,
    price_threshold: float,
    init_state: Optional[LState] = None,
    chunk: int = 64,
    max_rounds: int = 10_000_000,
    device=None,
):
    """Host-driven Khosla solve over shrinking slot-list levels.

    The semantics of ``khosla_solve`` (the same choice, update and drop
    rules and tie-breaks): full-scan chunks while more than
    ``max(512, n // 8)`` persons are active, then slot-list chunks,
    re-packed into the smallest level that holds the active set; one
    readback a chunk.  ``device`` (``None`` means ``"cuda"``) must be
    where ``problem`` lies.  Returns the final :class:`LState`."""
    dev = problem_on(problem, device)
    n, m = problem.num_rows, problem.num_cols
    np_dtype = numpy_dtype(problem.dtype)
    eps = np_dtype.type(eps)
    price_threshold = np_dtype.type(price_threshold)

    levels = _levels_for(n)
    if init_state is None:
        state = fresh_lstate(
            torch.zeros(m, dtype=problem.dtype, device=dev), n)
    else:
        state = init_state

    p = state.slots.shape[0]
    active, nits = _poll((state.slots != _INT_MAX).sum().to(torch.int32),
                         state)
    full_cutoff = max(512, n // 8)
    cur_chunk = 0
    while active > full_cutoff and nits < max_rounds:
        if cur_chunk == 0:
            cur_chunk = 8
        state, active_dev = khosla_full_chunk(problem, state, eps,
                                              price_threshold, cur_chunk)
        active, nits = _poll(active_dev, state)
        cur_chunk = min(128, cur_chunk * 2)
    trace_host("compact: full scan done, rounds={} active={}", nits, active)
    if active > 0:
        state = repack_slots(state, p)  # rebuild from the mask
    cur_chunk = 0
    while active > 0 and nits < max_rounds:
        target_p = next(lv for lv in reversed(levels) if lv >= active)
        if target_p < p:
            state = repack_slots(state, target_p)
            p = target_p
            cur_chunk = 0
        # large levels drain in a few rounds, small ones run long
        # chains: chunks grow within a level
        if cur_chunk == 0:
            cur_chunk = 8 if p >= 4096 else chunk
        state, active_dev = khosla_run_chunk(problem, state, eps,
                                             price_threshold, cur_chunk)
        active, nits = _poll(active_dev, state)
        cur_chunk = min(512, cur_chunk * 2)
    return state


def khosla_solve_scaled(
    problem: PaddedProblem,
    eps_target: float,
    w_min: float,
    w_max: float,
    reduction_factor: float = 0.125,
    start_eps: Optional[float] = None,
    chunk: int = 64,
    max_rounds: int = 10_000_000,
    start_prices=None,
    threshold_pad: float = 0.0,
    device=None,
):
    """An eps-scaling ladder around :func:`khosla_solve_compact`: from
    ``(w_max - w_min) / 4`` down by ``reduction_factor`` to
    ``eps_target``, assignments reset and prices kept between phases.
    The last phase runs at ``eps_target`` with the reference's price
    threshold, so the result carries the unscaled solver's certificate.

    Sound for symmetric instances only (the n-eps bound needs every
    object matched); an asymmetric instance runs one phase at
    ``eps_target``.  Each phase's drop threshold ``(m / 2)(span +
    eps)`` is shifted by its start price level (``threshold_pad`` for
    the first phase, the carried maximum after): carried prices may
    exceed a smaller phase's cold-start bound on feasible instances.
    Returns ``(state, total rounds)``."""
    dev = problem_on(problem, device)
    n, m = problem.num_rows, problem.num_cols
    np_dtype = numpy_dtype(problem.dtype)
    span = w_max - w_min
    if n != m:
        eps = eps_target
    else:
        eps = (start_eps if start_eps is not None
               else max(span / 4.0, eps_target))

    ladder = []
    while eps > eps_target:
        ladder.append(eps)
        eps *= reduction_factor
    ladder.append(eps_target)

    state = None
    if start_prices is not None:
        state = fresh_lstate(torch.from_numpy(
            np.asarray(start_prices, dtype=np_dtype).copy()).to(dev), n)
    total_rounds = 0
    for phase_i, phase_eps in enumerate(ladder):
        pad = threshold_pad if phase_i == 0 else max(
            0.0, float(state.prices.max()))
        threshold = (m / 2.0) * (span + phase_eps) + pad
        if phase_i > 0:
            state = fresh_lstate(state.prices, n)
        state = khosla_solve_compact(
            problem, phase_eps, threshold, init_state=state, chunk=chunk,
            max_rounds=max_rounds, device=dev,
        )
        total_rounds += int(state.nits)
    return state, total_rounds
