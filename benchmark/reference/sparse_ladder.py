"""A plain reference of the sparse ε-scaling auction: square batches of
arcs solved by Khosla's forward auction with the drop rule, under an
ε-scaling ladder, one instance after another.

Plain PyTorch in float64 on whatever device the arcs lie; it imports
nothing of the program (neither package), runs no kernel and stages
nothing.  The rules are those the program's ladder states
(``ops/compact.py:khosla_solve_scaled``): phases from a quarter of the
instance's value span down eightfold to the caller's ε, prices kept and
the matching reset between phases, each phase's drop threshold
``(m / 2)(span + ε)`` shifted by the largest carried price; a round lets
every active person bid ``best - second + ε`` for the best object (the
smallest column among equal profits), or drop where the price at its
best exceeds the threshold, and each object goes to its largest bid, the
smallest person on ties.  A column a person lists twice keeps its later
slot.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the ladder's step from one phase to the next
FACTOR = 0.125


def eps_ladder(span: float, eps: float) -> list:
    """Each phase's ε: from ``max(span / 4, eps)`` down by
    :data:`FACTOR` while above ``eps``, then ``eps``."""
    e = max(span / 4.0, eps)
    out = []
    while e > eps:
        out.append(e)
        e *= FACTOR
    return out + [eps]


def _arcs(columns, values, maximize: bool):
    """One instance's arcs as ``(cols [N, K] int64, work [N, K] float64,
    valid [N, K])``: the values sign-adjusted to a maximisation, a slot
    valid when it holds a column no later slot of its row repeats."""
    cols = columns.long()
    work = values.double() if maximize else -values.double()
    later = (cols[:, :, None] == cols[:, None, :]).triu(diagonal=1).any(
        dim=2)
    return cols, work, (cols >= 0) & ~later


def _phase(cols, work, valid, prices, eps: float, threshold: float,
           max_rounds: int):
    """One phase from ``prices`` with nobody assigned: rounds until no
    person is active.  Returns ``(p2o [N], prices, rounds)``; ``p2o``
    is -1 for an unassigned person."""
    n, m = cols.shape[0], prices.shape[0]
    p2o = torch.full((n,), -1, dtype=torch.int64, device=cols.device)
    dropped = torch.zeros(n, dtype=torch.bool, device=cols.device)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float64,
                           device=cols.device)
    rounds = 0
    while rounds < max_rounds:
        who = ((p2o < 0) & ~dropped).nonzero()[:, 0]
        if who.numel() == 0:
            break
        rounds += 1
        c, w, ok = cols[who], work[who], valid[who]
        profit = torch.where(ok, w - prices[c.clamp(min=0)], neg_inf)
        best = profit.amax(dim=1)
        col = torch.where(ok & (profit == best[:, None]), c, m).amin(dim=1)
        at = ok & (c == col[:, None])
        second = torch.where(at, neg_inf, profit).amax(dim=1)
        value = torch.where(at, w, neg_inf).amax(dim=1)
        drop = value - best > threshold
        dropped[who[drop]] = True
        who, col = who[~drop], col[~drop]
        bid = torch.where(second[~drop] > neg_inf,
                          value[~drop] - second[~drop],
                          value[~drop] - best[~drop]) + eps
        top = torch.full((m,), -float("inf"), dtype=torch.float64,
                         device=cols.device)
        top.scatter_reduce_(0, col, bid, "amax")
        first = torch.full((m,), n, dtype=torch.int64, device=cols.device)
        first.scatter_reduce_(0, col, torch.where(bid == top[col], who, n),
                              "amin")
        taken = top > neg_inf
        p2o[(p2o >= 0) & taken[p2o.clamp(min=0)]] = -1
        won = first[col] == who
        p2o[who[won]] = col[won]
        prices = torch.where(taken, top, prices)
    return p2o, prices, rounds


def solve(columns, values, num_cols: int, eps: float,
          maximize: bool = False, max_rounds: int = 10_000_000) -> dict:
    """Solve each instance of the arcs ``columns [B, N, K]`` (``-1``
    pads) and ``values [B, N, K]`` over ``num_cols == N`` objects.
    Returns ``p2o [B, N]`` (int64, -1 unassigned), ``objective [B]``
    (float64, the chosen arcs' values in original units), ``nits [B]``
    and ``rounds_by_phase`` (one list an instance)."""
    b, n, _ = columns.shape
    if n != num_cols:
        raise ValueError("the ladder takes square instances")
    p2o = torch.full((b, n), -1, dtype=torch.int64, device=columns.device)
    objective = torch.zeros(b, dtype=torch.float64, device=columns.device)
    by_phase = []
    for i in range(b):
        cols, work, valid = _arcs(columns[i], values[i], maximize)
        span = float(work[valid].max() - work[valid].min())
        prices = torch.zeros(num_cols, dtype=torch.float64,
                             device=cols.device)
        rounds = []
        for k, e in enumerate(eps_ladder(span, eps)):
            pad = 0.0 if k == 0 else max(0.0, float(prices.max()))
            threshold = (num_cols / 2.0) * (span + e) + pad
            p2o[i], prices, r = _phase(cols, work, valid, prices, e,
                                       threshold, max_rounds)
            rounds.append(r)
        by_phase.append(rounds)
        mine = valid & (cols == p2o[i][:, None]) & (p2o[i][:, None] >= 0)
        objective[i] = torch.where(mine, values[i].double(), 0.0).sum()
    nits = torch.tensor([sum(r) for r in by_phase], dtype=torch.int64)
    return dict(p2o=p2o, objective=objective, nits=nits,
                rounds_by_phase=by_phase)
