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

These are the executable specs of the batched-sparse kernel
(``ops/ksparse_kernel.py``) and of the fused dense round
(``ops/dense_round.py``).  Every reduction is a max or a min and the
arithmetic is adds and subtracts in the JAX association order, so the
results are bit-identical to the JAX rounds on the same inputs.  The
padded (gather) branches of the JAX module wait for the single sparse
device engines (ROADMAP.md §1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..solution import UNASSIGNED
from ..utils.trace import is_enabled, trace_round
from .dense import DenseProblem

_INT_MAX = UNASSIGNED


class KhoslaState(NamedTuple):
    prices: torch.Tensor   # [B, M] object prices
    p2o: torch.Tensor      # [B, N] int32
    o2p: torch.Tensor      # [B, M] int32
    dropped: torch.Tensor  # [B, N] bool
    nits: torch.Tensor     # [B] int32 rounds run with an active person


def _neg_inf(dtype, device) -> torch.Tensor:
    return torch.tensor(-np.inf, dtype=dtype, device=device)


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


def _price_at_best(problem, prices, best_col, best, best_val):
    """Price of each person's best object, reconstructed from the profit
    (``price = value - profit``) as the JAX dense path does.  In float32
    this can differ from the stored price in the last bit, and it feeds
    the drop test and the single-arc bid, so it is part of the spec."""
    del problem, prices, best_col
    return best_val - best


def khosla_round(problem: DenseProblem, s: KhoslaState, eps,
                 price_threshold) -> KhoslaState:
    """One synchronous Khosla round (choice, drop, price update, assign)
    of every instance.  ``eps`` is a scalar, ``price_threshold`` a
    ``[B]`` tensor (or a scalar).  An instance with no active person
    (unassigned and not dropped) comes out unchanged."""
    dtype, dev = s.prices.dtype, s.prices.device
    neg_inf = _neg_inf(dtype, dev)
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    threshold = torch.as_tensor(price_threshold, dtype=dtype, device=dev)
    if threshold.dim() == 1:
        threshold = threshold[:, None]

    active = (s.p2o == _INT_MAX) & ~s.dropped
    any_active = active.any(dim=1)
    best, second, best_col, best_val = _top2_profits_dense(problem, s.prices)
    price_at_best = _price_at_best(problem, s.prices, best_col, best,
                                   best_val)
    drop_now = active & (price_at_best > threshold)
    bidder = active & ~drop_now
    has_second = second != neg_inf
    raw_bid = torch.where(
        has_second, best_val - second + eps, price_at_best + eps
    )
    bid = torch.where(bidder, raw_bid, neg_inf)
    prices, p2o, o2p = _resolve_and_assign_dense(
        problem, s.prices, s.p2o, s.o2p, bid, best_col
    )
    if is_enabled():
        trace_round(
            "khosla round {}: active={} dropped={}",
            s.nits, active.sum(dim=1), drop_now.sum(dim=1),
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


def ecs_margins(problem: DenseProblem, prices: torch.Tensor,
                p2o: torch.Tensor):
    """Per-person ``(chosen_profit, max_profit)``, each ``[B, N]``, for
    eps-complementary-slackness checks: the profit of the person's own
    object (``-inf`` when unassigned) and the largest profit it could
    have at these prices."""
    vals_t = problem.vals_t
    neg_inf = _neg_inf(vals_t.dtype, vals_t.device)
    j_iota, _ = _iotas(vals_t)
    profit = vals_t - prices[:, :, None]
    max_profit = profit.amax(dim=1)
    is_chosen = p2o[:, None, :] == j_iota
    chosen_profit = torch.where(is_chosen, profit, neg_inf).amax(dim=1)
    return chosen_profit, max_profit


def forward_round(problem: DenseProblem, s: ForwardState, target_eps,
                  toleration, start_from_optimal_eps, max_iterations,
                  keep_valid: bool = False) -> ForwardState:
    """One forward-auction round of every instance with the eps-scaling
    bookkeeping.  An instance whose ``done`` is set comes out unchanged.

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
    masked with ``fully``."""
    dtype, dev = s.prices.dtype, s.prices.device
    neg_inf = _neg_inf(dtype, dev)
    target = torch.as_tensor(target_eps, dtype=dtype, device=dev)
    tol = torch.as_tensor(toleration, dtype=dtype, device=dev)
    sfoe = torch.as_tensor(start_from_optimal_eps, dtype=torch.bool,
                           device=dev)

    unassigned = (s.p2o == _INT_MAX) & ~s.done[:, None]
    best, second, best_col, best_val = _top2_profits_dense(problem, s.prices)
    has_second = second != neg_inf
    eps_col = s.eps[:, None]
    raw_bid = torch.where(
        has_second,
        best_val - second + eps_col,
        _price_at_best(problem, s.prices, best_col, best, best_val)
        + eps_col,
    )
    bid = torch.where(unassigned & (best != neg_inf), raw_bid, neg_inf)
    prices, p2o, o2p = _resolve_and_assign_dense(
        problem, s.prices, s.p2o, s.o2p, bid, best_col
    )
    nits = s.nits + (~s.done).to(torch.int32)
    num_unassigned = (p2o == _INT_MAX).sum(dim=1)
    fully = (num_unassigned == 0) & ~s.done

    chosen_profit, max_profit = ecs_margins(problem, prices, p2o)
    is_optimal = sfoe | (
        chosen_profit + tol >= max_profit - target
    ).all(dim=1)
    # stop when optimal, or already below the target eps
    stop = is_optimal | (s.eps < target)
    reduce = fully & ~stop
    eps = torch.where(
        reduce, s.eps * torch.tensor(0.15, dtype=dtype, device=dev), s.eps
    )
    if keep_valid:
        keep = (p2o != _INT_MAX) & (
            chosen_profit + tol >= max_profit - eps[:, None]
        )
        p2o = torch.where(reduce[:, None] & ~keep, _INT_MAX, p2o)
    else:
        p2o = torch.where(reduce[:, None], _INT_MAX, p2o)
        o2p = torch.where(reduce[:, None], _INT_MAX, o2p)
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
