"""Synchronous Jacobi auction rounds on dense problems, in plain PyTorch.

The dense branch of the JAX package's ``ops/auction.py`` with ``vmap``
written out as a leading batch dimension: in one round every active
person bids at the prices of the round's start,

1. **bidding**: per-person top-2 profit (value - price), the smallest
   object index among equal profits;
2. **conflict resolution**: each object takes its largest bid, the
   smallest person among equal bids;
3. **assignment**: the price becomes the winning bid, the winner takes
   the object, a displaced owner becomes unassigned.

Khosla's rule on top: an active person whose best object is already
priced above the instance's threshold is dropped for good, which ends
infeasible instances in finitely many rounds.

The forward auction on top (``forward_round``): every unassigned person
of an instance that is not done bids; a complete assignment is checked
against eps-complementary slackness (``ecs_margins``) and eps shrinks
until the target is certified.

Two problem forms, as in the JAX module: a ``DenseProblem``
(``ops/dense.py``; broadcasts and reductions, no gathers), batched with
a leading dimension, and a ``PaddedProblem`` (``ops/padded.py``): one
instance, or with a leading batch dimension (``solve_batch_sparse``'s
padded engine), where each lookup is a gather and conflicts resolve
over each object's incident persons.  ``khosla_round``,
``forward_round``, ``top2_profits``, ``resolve_and_assign`` and
``ecs_margins`` take either.  The padded rounds are plain PyTorch by
design: the JAX package wrote them as plain XLA (no Pallas kernel
there, Mosaic cannot gather).

The dense rounds are the executable specs of the batched-sparse kernel
(``ops/ksparse_kernel.py``) and of the fused dense round
(``ops/dense_round.py``).  Every reduction is a max or a min and the
arithmetic is adds and subtracts in the JAX association order, so the
results are bit-identical to the JAX rounds on the same inputs.

Drivers of one padded instance: ``khosla_solve`` and ``forward_solve``
run to the end in host-polled chunks (the JAX package's
``lax.while_loop``; one readback a chunk), ``forward_solve_chunked``
runs growing chunks with the infeasibility certificate.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..solution import UNASSIGNED
from ..utils.trace import is_enabled, trace_round
from . import graphs
from .dense import DenseProblem
from .padded import PaddedProblem, numpy_dtype

_INT_MAX = UNASSIGNED


class KhoslaState(NamedTuple):
    """Batched ``[B, ...]``, or one padded instance without the batch
    dimension (``nits`` then 0-dim)."""
    prices: torch.Tensor   # [B, M] object prices
    p2o: torch.Tensor      # [B, N] int32
    o2p: torch.Tensor      # [B, M] int32
    dropped: torch.Tensor  # [B, N] bool
    nits: torch.Tensor     # [B] int32 rounds run with an active person


def _neg_inf(dtype, device) -> torch.Tensor:
    # a fill, not a copy from host memory: rounds are captured in graphs
    return torch.full((), -np.inf, dtype=dtype, device=device)


def _iotas(vals_t):
    _, m, n = vals_t.shape
    dev = vals_t.device
    j_iota = torch.arange(m, dtype=torch.int32, device=dev)[None, :, None]
    u_iota = torch.arange(n, dtype=torch.int32, device=dev)[None, None, :]
    return j_iota, u_iota


def _top2_profits_dense(problem: DenseProblem, prices: torch.Tensor):
    """Best and second-best profit per person with the best object's
    index (the first maximum) and value.  Returns ``(best, second,
    best_j, best_val)``, each ``[B, N]``; ``second`` is the maximum over
    every object but ``best_j``, ``-inf`` for a person with one arc."""
    vals_t = problem.vals_t
    neg_inf = _neg_inf(vals_t.dtype, vals_t.device)
    m = vals_t.shape[1]
    j_iota, _ = _iotas(vals_t)
    profit = vals_t - prices[:, :, None]
    best = profit.amax(dim=1)
    is_best = profit == best[:, None, :]
    best_j = torch.where(is_best, j_iota, m).amin(dim=1)
    sel = j_iota == best_j[:, None, :]
    second = torch.where(sel, neg_inf, profit).amax(dim=1)
    best_val = torch.where(sel, vals_t, neg_inf).amax(dim=1)
    return best, second, best_j, best_val


def _resolve_and_assign_dense(problem: DenseProblem, prices, p2o, o2p, bid,
                              bid_col):
    """One synchronous assignment phase.  ``bid [B, N]`` is ``-inf`` for
    non-bidders, ``bid_col [B, N]`` the object each person bids on.
    Each object takes the largest bid (smallest person on ties); its
    price becomes that bid, the winner is assigned and the previous
    owner becomes unassigned.  Returns ``(prices, p2o, o2p)``."""
    vals_t = problem.vals_t
    neg_inf = _neg_inf(bid.dtype, bid.device)
    j_iota, u_iota = _iotas(vals_t)

    bidding = bid != neg_inf
    is_here = (bid_col[:, None, :] == j_iota) & bidding[:, None, :]
    eff = torch.where(is_here, bid[:, None, :], neg_inf)
    max_bid = eff.amax(dim=2)                                  # [B, M]
    has_winner = max_bid != neg_inf
    cand = torch.where(
        is_here & (eff >= max_bid[:, :, None]), u_iota, _INT_MAX
    )
    winner = cand.amin(dim=2)                                  # [B, M]

    prices_new = torch.where(has_winner, max_bid.to(prices.dtype), prices)
    o2p_new = torch.where(has_winner, winner, o2p)

    won = (is_here & (winner[:, :, None] == u_iota)).any(dim=1)  # [B, N]
    assigned = p2o != _INT_MAX
    displaced = assigned & (
        (p2o[:, None, :] == j_iota) & has_winner[:, :, None]
    ).any(dim=1)
    p2o_new = torch.where(
        won, bid_col, torch.where(displaced, _INT_MAX, p2o)
    )
    return prices_new, p2o_new, o2p_new


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per instance: ``x [M]`` with any ``idx``, or
    ``x [B, M]`` with ``idx [B, ...]``; shaped like ``idx``.  Indices
    widen to int64 for the gather only."""
    if x.dim() == 1:
        return x[idx.long()]
    b = x.shape[0]
    return x.gather(1, idx.reshape(b, -1).long()).reshape(idx.shape)


def top2_profits_arrays(row_cols, row_vals, row_mask, prices):
    """Per-person top-2 over padded arc slots ``[..., K, N]`` (a batch
    dimension in front, or none) at ``prices [..., M]``: ``(best,
    second, best_col, best_val)``, each ``[..., N]``.  The best slot is
    the first maximum, the reference's strict ``>`` update."""
    dtype = row_vals.dtype
    neg_inf = _neg_inf(dtype, row_vals.device)
    profit = torch.where(row_mask, row_vals - _gather(prices, row_cols),
                         neg_inf)
    k = profit.shape[-2]
    best = profit.amax(dim=-2)
    k_iota = torch.arange(k, dtype=torch.int32,
                          device=profit.device)[:, None]
    is_best = profit == best[..., None, :]
    best_k = torch.where(is_best, k_iota, k).amin(dim=-2)
    sel = k_iota == best_k[..., None, :]
    second = torch.where(sel, neg_inf, profit).amax(dim=-2)
    best_col = torch.where(sel, row_cols, 0).amax(dim=-2)
    best_val = torch.where(sel, row_vals, neg_inf).amax(dim=-2)
    return best, second, best_col, best_val


def top2_profits(problem, prices: torch.Tensor):
    """Best and second-best profit per person with the best object's
    index and value, for either problem form."""
    if isinstance(problem, DenseProblem):
        return _top2_profits_dense(problem, prices)
    return top2_profits_arrays(problem.row_cols, problem.row_vals,
                               problem.row_mask, prices)


def _resolve_and_assign_padded(problem: PaddedProblem, prices, p2o, o2p,
                               bid, bid_col):
    """Conflict resolution by gathers: each object reads its incident
    persons' bids (``col_persons``), takes the largest (the smallest
    person on ties); its price becomes that bid, the winner takes it and
    the previous owner becomes unassigned."""
    neg_inf = _neg_inf(bid.dtype, bid.device)
    n = p2o.shape[-1]
    inc_bid = _gather(bid, problem.col_persons)         # [..., Kc, M]
    inc_tgt = _gather(bid_col, problem.col_persons)     # [..., Kc, M]
    m = inc_bid.shape[-1]
    obj_ids = torch.arange(m, dtype=torch.int32, device=bid.device)
    is_here = problem.col_mask & (inc_tgt == obj_ids) & (inc_bid != neg_inf)
    eff = torch.where(is_here, inc_bid, neg_inf)
    max_bid = eff.amax(dim=-2)                          # [..., M]
    has_winner = max_bid != neg_inf
    cand = torch.where(is_here & (eff >= max_bid[..., None, :]),
                       problem.col_persons, _INT_MAX)
    winner = cand.amin(dim=-2)                          # [..., M]

    prices_new = torch.where(has_winner, max_bid.to(prices.dtype), prices)
    o2p_new = torch.where(has_winner, winner, o2p)

    person_iota = torch.arange(n, dtype=torch.int32, device=bid.device)
    bidding = bid != neg_inf
    safe_tgt = torch.where(bidding, bid_col, 0)
    won = bidding & (_gather(winner, safe_tgt) == person_iota)
    assigned = p2o != _INT_MAX
    safe_cur = torch.where(assigned, p2o, 0)
    displaced = assigned & _gather(has_winner, safe_cur)
    p2o_new = torch.where(won, bid_col,
                          torch.where(displaced, _INT_MAX, p2o))
    return prices_new, p2o_new, o2p_new


def resolve_and_assign(problem, prices, p2o, o2p, bid, bid_col):
    """One synchronous assignment phase, for either problem form:
    ``bid`` is ``-inf`` for non-bidders, ``bid_col`` the object each
    person bids on.  Returns ``(prices, p2o, o2p)``."""
    if isinstance(problem, DenseProblem):
        return _resolve_and_assign_dense(problem, prices, p2o, o2p, bid,
                                         bid_col)
    return _resolve_and_assign_padded(problem, prices, p2o, o2p, bid,
                                      bid_col)


def _price_at_best(problem, prices, best_col, best, best_val):
    """Price of each person's best object.  The dense form reconstructs
    it from the profit (``price = value - profit``) as the JAX dense
    path does; in float32 this can differ from the stored price in the
    last bit, and it feeds the drop test and the single-arc bid, so it
    is part of the spec.  The padded form gathers the stored price."""
    if isinstance(problem, DenseProblem):
        return best_val - best
    return _gather(prices, best_col)


def khosla_round(problem, s: KhoslaState, eps,
                 price_threshold, trace: bool = True) -> KhoslaState:
    """One synchronous Khosla round (choice, drop, price update, assign)
    of every instance, dense or padded.  ``eps`` is a scalar,
    ``price_threshold`` a ``[B]`` tensor of a batch (or a scalar).  An
    instance with no active person (unassigned and not dropped) comes
    out unchanged.  ``trace=False`` leaves out the round's trace line
    (the kernel's plain version prints the kernel's rows instead)."""
    dtype, dev = s.prices.dtype, s.prices.device
    neg_inf = _neg_inf(dtype, dev)
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    threshold = torch.as_tensor(price_threshold, dtype=dtype, device=dev)
    if threshold.dim() == 1:
        threshold = threshold[:, None]

    active = (s.p2o == _INT_MAX) & ~s.dropped
    any_active = active.any(dim=-1)
    best, second, best_col, best_val = top2_profits(problem, s.prices)
    price_at_best = _price_at_best(problem, s.prices, best_col, best,
                                   best_val)
    drop_now = active & (price_at_best > threshold)
    bidder = active & ~drop_now
    has_second = second != neg_inf
    raw_bid = torch.where(
        has_second, best_val - second + eps, price_at_best + eps
    )
    bid = torch.where(bidder, raw_bid, neg_inf)
    prices, p2o, o2p = resolve_and_assign(
        problem, s.prices, s.p2o, s.o2p, bid, best_col
    )
    if trace and is_enabled():
        trace_round(
            "khosla round {}: active={} dropped={}",
            s.nits, active.sum(dim=-1), drop_now.sum(dim=-1),
        )
    return KhoslaState(
        prices=prices,
        p2o=p2o,
        o2p=o2p,
        dropped=s.dropped | drop_now,
        nits=s.nits + any_active.to(torch.int32),
    )


def _state_from_numpy(cls, int_fields, bool_fields, np_fields, device):
    dev = resolve_device(device)
    out = {}
    for name in cls._fields:
        arr = np.array(np_fields[name])  # a writable copy
        if name in int_fields:
            arr = arr.astype(np.int32)
        elif name in bool_fields:
            arr = arr.astype(bool)
        out[name] = torch.from_numpy(arr).to(dev)
    return cls(**out)


def khosla_state_from_jax(np_fields: dict, device=None) -> KhoslaState:
    """A batched :class:`KhoslaState` from the JAX package's
    ``KhoslaState`` fields given as numpy arrays (``{"prices": ...,
    "p2o": ..., "o2p": ..., "dropped": ..., "nits": ...}``): the carried
    auction state is what moves between the two packages.
    ``device=None`` means ``"cuda"``."""
    return _state_from_numpy(KhoslaState, ("p2o", "o2p", "nits"),
                             ("dropped",), np_fields, device)


def khosla_state_to_numpy(state: KhoslaState) -> dict:
    """The inverse of :func:`khosla_state_from_jax`: every field as a
    numpy array, keyed by field name."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in KhoslaState._fields
    }


# ----------------------------------------------------------------------
# Forward auction with eps-scaling (dense problems)
# ----------------------------------------------------------------------
class ForwardState(NamedTuple):
    prices: torch.Tensor         # [B, M] object prices
    p2o: torch.Tensor            # [B, N] int32
    o2p: torch.Tensor            # [B, M] int32 (stale under keep_valid)
    eps: torch.Tensor            # [B] value dtype, the current eps
    nits: torch.Tensor           # [B] int32 rounds run while not done
    nreductions: torch.Tensor    # [B] int32 eps reductions
    optimal_found: torch.Tensor  # [B] bool
    done: torch.Tensor           # [B] bool


_FORWARD_INT_FIELDS = ("p2o", "o2p", "nits", "nreductions")
_FORWARD_BOOL_FIELDS = ("optimal_found", "done")


def forward_init(vals_t: torch.Tensor, start_eps) -> ForwardState:
    """Initial batched state of ``vals_t [B, M, N]``: zero prices, nobody
    assigned, ``start_eps`` (a scalar or ``[B]``) as each instance's
    eps."""
    b, m, n = vals_t.shape
    dtype, dev = vals_t.dtype, vals_t.device
    return ForwardState(
        prices=torch.zeros((b, m), dtype=dtype, device=dev),
        p2o=torch.full((b, n), _INT_MAX, dtype=torch.int32, device=dev),
        o2p=torch.full((b, m), _INT_MAX, dtype=torch.int32, device=dev),
        eps=torch.as_tensor(start_eps, dtype=dtype,
                            device=dev).expand(b).clone(),
        nits=torch.zeros(b, dtype=torch.int32, device=dev),
        nreductions=torch.zeros(b, dtype=torch.int32, device=dev),
        optimal_found=torch.zeros(b, dtype=torch.bool, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
    )


def _ecs_margins_padded(problem: PaddedProblem, prices, p2o):
    neg_inf = _neg_inf(prices.dtype, prices.device)
    profit = torch.where(
        problem.row_mask,
        problem.row_vals - _gather(prices, problem.row_cols),
        neg_inf,
    )
    max_profit = profit.amax(dim=-2)
    is_chosen = problem.row_mask & (problem.row_cols == p2o[..., None, :])
    chosen_val = torch.where(is_chosen, problem.row_vals,
                             neg_inf).amax(dim=-2)
    safe_j = torch.where(p2o != _INT_MAX, p2o, 0)
    return chosen_val - _gather(prices, safe_j), max_profit


def ecs_margins(problem, prices: torch.Tensor, p2o: torch.Tensor):
    """Per-person ``(chosen_profit, max_profit)`` for
    eps-complementary-slackness checks: the profit of the person's own
    object (``-inf`` when unassigned) and the largest profit it could
    have at these prices.  ``[B, N]`` each for a dense batch, ``[N]``
    for one padded instance."""
    if isinstance(problem, PaddedProblem):
        return _ecs_margins_padded(problem, prices, p2o)
    vals_t = problem.vals_t
    neg_inf = _neg_inf(vals_t.dtype, vals_t.device)
    j_iota, _ = _iotas(vals_t)
    profit = vals_t - prices[:, :, None]
    max_profit = profit.amax(dim=1)
    is_chosen = p2o[:, None, :] == j_iota
    chosen_profit = torch.where(is_chosen, profit, neg_inf).amax(dim=1)
    return chosen_profit, max_profit


def forward_round(problem, s: ForwardState, target_eps,
                  toleration, start_from_optimal_eps, max_iterations,
                  keep_valid: bool = False) -> ForwardState:
    """One forward-auction round of every instance with the eps-scaling
    bookkeeping: a dense batch, or one padded instance (a state without
    the batch dimension).  An instance whose ``done`` is set comes out
    unchanged.

    Bid rule: best value minus second-best profit plus eps.  A person
    with a single arc (second = ``-inf``) bids ``price + eps``, the
    Khosla guard, where the reference crate bids ``+inf`` and poisons
    the price (the deliberate deviation of ``docs/PARITY.md``).

    When an instance's assignment is complete, it stops if the eps-CS
    certificate holds at ``target_eps`` (or ``start_from_optimal_eps``
    is set, or eps is already below the target); otherwise eps shrinks
    by 0.15 and the assignment is reset: entirely, or with
    ``keep_valid`` only the pairs that violate eps-CS at the reduced
    eps.  ``keep_valid`` leaves ``o2p`` stale (rounds only ever write
    it); the caller rebuilds it from the final ``p2o``.

    The JAX round's ``lax.cond(fully, ...)`` is a select here, as it is
    under ``vmap``: the margins are computed for every instance and
    masked with ``fully``; so is it for one padded instance."""
    dtype, dev = s.prices.dtype, s.prices.device
    neg_inf = _neg_inf(dtype, dev)
    target = torch.as_tensor(target_eps, dtype=dtype, device=dev)
    tol = torch.as_tensor(toleration, dtype=dtype, device=dev)
    sfoe = torch.as_tensor(start_from_optimal_eps, dtype=torch.bool,
                           device=dev)

    unassigned = (s.p2o == _INT_MAX) & ~s.done[..., None]
    best, second, best_col, best_val = top2_profits(problem, s.prices)
    has_second = second != neg_inf
    eps_col = s.eps[..., None]
    raw_bid = torch.where(
        has_second,
        best_val - second + eps_col,
        _price_at_best(problem, s.prices, best_col, best, best_val)
        + eps_col,
    )
    bid = torch.where(unassigned & (best != neg_inf), raw_bid, neg_inf)
    prices, p2o, o2p = resolve_and_assign(
        problem, s.prices, s.p2o, s.o2p, bid, best_col
    )
    nits = s.nits + (~s.done).to(torch.int32)
    num_unassigned = (p2o == _INT_MAX).sum(dim=-1)
    fully = (num_unassigned == 0) & ~s.done

    chosen_profit, max_profit = ecs_margins(problem, prices, p2o)
    is_optimal = sfoe | (
        chosen_profit + tol >= max_profit - target
    ).all(dim=-1)
    # stop when optimal, or already below the target eps
    stop = is_optimal | (s.eps < target)
    reduce = fully & ~stop
    eps = torch.where(
        reduce, s.eps * torch.full((), 0.15, dtype=dtype, device=dev),
        s.eps
    )
    if keep_valid:
        keep = (p2o != _INT_MAX) & (
            chosen_profit + tol >= max_profit - eps[..., None]
        )
        p2o = torch.where(reduce[..., None] & ~keep, _INT_MAX, p2o)
    else:
        p2o = torch.where(reduce[..., None], _INT_MAX, p2o)
        o2p = torch.where(reduce[..., None], _INT_MAX, o2p)
    if is_enabled():
        trace_round("forward round {}: unassigned={} eps={}",
                    nits, num_unassigned, eps)
    return ForwardState(
        prices=prices,
        p2o=p2o,
        o2p=o2p,
        eps=eps,
        nits=nits,
        nreductions=s.nreductions + reduce.to(torch.int32),
        optimal_found=s.optimal_found | (fully & is_optimal),
        done=s.done | (fully & stop) | (nits >= max_iterations),
    )


def forward_state_from_jax(np_fields: dict, device=None) -> ForwardState:
    """A batched :class:`ForwardState` from the JAX package's
    ``ForwardState`` fields given as numpy arrays, keyed by field name:
    the carried auction state is what moves between the two packages.
    ``device=None`` means ``"cuda"``."""
    return _state_from_numpy(ForwardState, _FORWARD_INT_FIELDS,
                             _FORWARD_BOOL_FIELDS, np_fields, device)


def forward_state_to_numpy(state: ForwardState) -> dict:
    """The inverse of :func:`forward_state_from_jax`: every field as a
    numpy array, keyed by field name."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in ForwardState._fields
    }


def ecs_satisfied_device(problem, prices: torch.Tensor, p2o: torch.Tensor,
                         eps, toleration) -> torch.Tensor:
    """eps-complementary slackness on the device (a bool tensor); only
    meaningful for a complete assignment."""
    chosen_profit, max_profit = ecs_margins(problem, prices, p2o)
    eps = torch.as_tensor(eps, dtype=prices.dtype, device=prices.device)
    tol = torch.as_tensor(toleration, dtype=prices.dtype,
                          device=prices.device)
    return (chosen_profit + tol >= max_profit - eps).all(dim=-1)


# ----------------------------------------------------------------------
# Drivers of one padded instance
# ----------------------------------------------------------------------
def _scalar(x, dtype: torch.dtype, dev) -> torch.Tensor:
    """A 0-dim tensor of ``dtype``: a Python or NumPy scalar rounds to
    the problem's type once, as JAX's ``jnp.asarray(x, dtype)`` does,
    so no float32 expression is widened by a float64 operand."""
    return torch.tensor(x, dtype=dtype, device=dev)


def _khosla_init(problem: PaddedProblem) -> KhoslaState:
    n, m, dev = problem.num_rows, problem.num_cols, problem.device
    return KhoslaState(
        prices=torch.zeros(m, dtype=problem.dtype, device=dev),
        p2o=torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev),
        o2p=torch.full((m,), _INT_MAX, dtype=torch.int32, device=dev),
        dropped=torch.zeros(n, dtype=torch.bool, device=dev),
        nits=torch.zeros((), dtype=torch.int32, device=dev),
    )


def khosla_solve(problem: PaddedProblem, eps, price_threshold,
                 max_rounds: int = 10_000_000, chunk: int = 64):
    """Solve one padded instance with the Khosla auction: rounds until
    no person is active (unassigned and not dropped) or ``max_rounds``
    rounds have run.  The drop rule (a person whose best object is
    already priced above ``price_threshold`` leaves for good) ends
    infeasible instances; ``max_rounds`` guards float32, where ``price
    + eps`` can round to ``price``.

    The JAX package's ``lax.while_loop``, polled from the host once a
    chunk of rounds (chunks double up to ``1024``, never past
    ``max_rounds``): a round with no active person changes nothing, so
    the state equals the loop's.  Runs on the problem's device.
    Returns ``(prices, p2o, o2p, num_unassigned, nits)`` as tensors."""
    dtype, dev = problem.dtype, problem.device
    eps_t = _scalar(eps, dtype, dev)
    thr_t = _scalar(price_threshold, dtype, dev)
    state = _khosla_init(problem)
    cur = min(chunk, 8)
    while True:
        active = ((state.p2o == _INT_MAX) & ~state.dropped).any()
        any_active, nits = torch.stack(
            (active.to(torch.int32), state.nits)).tolist()
        if not any_active or nits >= max_rounds:
            break
        for _ in range(min(cur, max_rounds - nits)):
            state = khosla_round(problem, state, eps_t, thr_t)
        cur = min(1024, cur * 2)
    num_unassigned = (state.p2o == _INT_MAX).sum().to(torch.int32)
    return state.prices, state.p2o, state.o2p, num_unassigned, state.nits


def _forward_init(problem: PaddedProblem, start_eps,
                  start_prices=None) -> ForwardState:
    n, m, dev = problem.num_rows, problem.num_cols, problem.device
    dtype = problem.dtype
    if start_prices is None:
        prices = torch.zeros(m, dtype=dtype, device=dev)
    else:
        np_dtype = numpy_dtype(dtype)
        prices = torch.from_numpy(
            np.array(start_prices, dtype=np_dtype)).to(dev)
    return ForwardState(
        prices=prices,
        p2o=torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev),
        o2p=torch.full((m,), _INT_MAX, dtype=torch.int32, device=dev),
        eps=_scalar(start_eps, dtype, dev),
        nits=torch.zeros((), dtype=torch.int32, device=dev),
        nreductions=torch.zeros((), dtype=torch.int32, device=dev),
        optimal_found=torch.zeros((), dtype=torch.bool, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _forward_result(state: ForwardState):
    num_unassigned = (state.p2o == _INT_MAX).sum().to(torch.int32)
    return (state.prices, state.p2o, state.o2p, num_unassigned,
            state.nits, state.nreductions, state.optimal_found, state.eps)


def _forward_scalars(problem, target_eps, toleration,
                     start_from_optimal_eps):
    dtype, dev = problem.dtype, problem.device
    return (_scalar(target_eps, dtype, dev), _scalar(toleration, dtype, dev),
            torch.tensor(bool(start_from_optimal_eps), device=dev))


def _forward_chunk(problem, state, target, tol, sfoe, bound,
                   max_iterations, chunk):
    for _ in range(chunk):
        state = forward_round(problem, state, target, tol, sfoe,
                              max_iterations)
    return state._replace(done=state.done | (state.prices.max() > bound))


def forward_solve(problem: PaddedProblem, start_eps, target_eps,
                  toleration, start_from_optimal_eps, max_iterations,
                  chunk: int = 64):
    """Solve one padded instance with the eps-scaling forward auction:
    rounds until the assignment is complete and eps-CS holds at
    ``target_eps`` (a complete assignment that fails resets with kept
    prices and ``eps *= 0.15``), or ``max_iterations`` rounds.

    The JAX package's ``lax.while_loop``, polled once a chunk of rounds:
    a round of a finished instance changes nothing.  Returns ``(prices,
    p2o, o2p, num_unassigned, nits, nreductions, optimal_found, eps)``
    as tensors."""
    target, tol, sfoe = _forward_scalars(problem, target_eps, toleration,
                                         start_from_optimal_eps)
    state = _forward_init(problem, start_eps)
    cur = chunk
    while not bool(state.done):
        for _ in range(cur):
            state = forward_round(problem, state, target, tol, sfoe,
                                  max_iterations)
        cur = min(1024, cur * 2)
    return _forward_result(state)


def forward_run_chunk(problem: PaddedProblem, state: ForwardState,
                      target_eps, toleration, start_from_optimal_eps,
                      max_iterations, chunk: int, price_bound=None):
    """``chunk`` forward rounds.  ``price_bound`` (a scalar of the
    problem's type; ``None`` disarms) is the infeasibility certificate:
    a feasible instance's prices never exceed it, so a larger price
    after the chunk sets ``done`` with the matching incomplete (checked
    once a chunk, one ``[M]`` max).  On a CUDA device the chunk replays
    as a captured graph (``ops/graphs.py``)."""
    dt = problem.dtype
    # a disarmed certificate is an infinite bound: no price exceeds it
    bound = np.inf if price_bound is None else price_bound
    scalars = ((target_eps, dt), (toleration, dt),
               (start_from_optimal_eps, torch.bool), (bound, dt))
    return graphs.run(_forward_chunk, problem, state, scalars, chunk,
                      (int(max_iterations),))


def forward_solve_chunked(
    problem: PaddedProblem,
    start_eps,
    target_eps,
    toleration,
    start_from_optimal_eps,
    max_iterations,
    chunk: int = 64,
    start_prices=None,
    max_chunk: int = 1024,
    value_bound=None,
    device=None,
):
    """Host-driven forward solve: the semantics and return values of
    :func:`forward_solve`, in chunks that double up to ``max_chunk``,
    one ``done`` readback a chunk.  ``device`` (``None`` means
    ``"cuda"``) must be where ``problem`` lies.

    ``start_prices`` warm-starts the prices; eps-CS optimality at the
    end holds for any start prices on instances that reach a complete
    assignment.

    ``value_bound`` (``C``, the largest ``|value|`` over the arcs) arms
    the **infeasibility certificate**: within one eps phase started at
    prices ``p``, a feasible instance's prices never exceed ``max(p) +
    (2n - 1) C + (n - 1) eps`` (Bertsekas' bound for the auction).  Over
    the eps ladder the phase bounds telescope, so the armed bound is
    ``max(p0) + (K + 1)(2n + 1)(C + eps0) + 1`` with ``K`` an upper
    bound of the phase count (ladder factor 1/2; the real 0.15 has
    fewer phases).  Crossing it proves infeasibility and the loop stops
    with the matching incomplete, where the reference crate's only
    cutoff is ``max_iterations``.  It never trips on a feasible
    instance.  A bound that overflows the problem's float type disarms
    the certificate with a ``RuntimeWarning``."""
    from .padded import problem_on

    problem_on(problem, device)
    n = problem.num_rows
    np_dtype = numpy_dtype(problem.dtype)
    price_bound = None
    if value_bound is not None:
        p0_max = (0.0 if start_prices is None
                  else float(np.max(np.asarray(start_prices))))
        eps_hi = max(float(start_eps), float(target_eps))
        ratio = float(start_eps) / max(float(target_eps), 1e-300)
        phases = (1 if ratio <= 1.0
                  else int(np.ceil(np.log2(max(ratio, 2.0)))) + 1)
        bound64 = (float(p0_max)
                   + float(phases + 1) * float(2 * n + 1)
                   * (float(value_bound) + float(eps_hi)) + 1.0)
        with np.errstate(over="ignore"):
            price_bound = np_dtype.type(bound64)
        if not np.isfinite(price_bound):
            warnings.warn(
                f"infeasibility-certificate price bound {bound64:.3e} "
                f"overflows {np_dtype.name}; certificate disarmed: "
                f"infeasible instances will run to max_iterations "
                f"(use dtype=float64 to keep it armed)",
                RuntimeWarning,
                stacklevel=2,
            )
            price_bound = None

    state = _forward_init(problem, np_dtype.type(start_eps), start_prices)
    target_eps = np_dtype.type(target_eps)
    toleration = np_dtype.type(toleration)
    max_iterations = int(np.int32(max_iterations))
    cur = chunk
    while not bool(state.done):
        state = forward_run_chunk(problem, state, target_eps, toleration,
                                  start_from_optimal_eps, max_iterations,
                                  cur, price_bound=price_bound)
        cur = min(max_chunk, cur * 2)
    return _forward_result(state)
