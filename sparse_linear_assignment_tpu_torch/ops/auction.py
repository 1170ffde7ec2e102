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

This is the executable spec of the batched-sparse kernel
(``ops/ksparse_kernel.py``).  Every reduction is a max or a min and the
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


def khosla_state_from_jax(np_fields: dict, device=None) -> KhoslaState:
    """A batched :class:`KhoslaState` from the JAX package's
    ``KhoslaState`` fields given as numpy arrays (``{"prices": ...,
    "p2o": ..., "o2p": ..., "dropped": ..., "nits": ...}``): the carried
    auction state is what moves between the two packages.
    ``device=None`` means ``"cuda"``."""
    dev = resolve_device(device)
    out = {}
    for name in KhoslaState._fields:
        arr = np.array(np_fields[name])  # a writable copy
        if name in ("p2o", "o2p", "nits"):
            arr = arr.astype(np.int32)
        elif name == "dropped":
            arr = arr.astype(bool)
        out[name] = torch.from_numpy(arr).to(dev)
    return KhoslaState(**out)


def khosla_state_to_numpy(state: KhoslaState) -> dict:
    """The inverse of :func:`khosla_state_from_jax`: every field as a
    numpy array, keyed by field name."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in KhoslaState._fields
    }
