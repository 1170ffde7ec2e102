"""Forward-reverse auction rounds for dense instances, in plain PyTorch.

The executable spec of the FR kernel (``ops/fr_kernel.py``): the same
arithmetic as the JAX package's ``ops/fr_dense.py``, with ``vmap``
written out as a leading batch dimension.  Every tensor is batched:
``vals_t [B, M, N]`` holds object ``j``'s value for person ``i`` at
``[b, j, i]``.

Duality bookkeeping: persons carry profits ``pi [B, N]`` beside object
prices ``p [B, M]``, with ``pi_i + p_j >= a_ij - eps`` for all pairs
and equality on assigned pairs.

- forward sub-round (unassigned persons bid): the winner of object
  ``j`` pays ``p_j + (best - floor + eps)`` and records
  ``pi_i = floor - eps``;
- reverse sub-round (unassigned objects bid back for persons by
  cutting their own price): the mirror image on the transpose.

Each round runs only the current mode's sub-round; the mode flips when
the matching cardinality rises, or after ``stall_k`` rounds without a
rise (``stall_k`` doubles on every such preemption and resets to
``STALL_K0`` on a rise).  Bids travel in increment form and conflicts
go to the largest increment, smallest bidder index on ties.  Floats use
adds and subtracts in the JAX association order, so results are
bit-identical to the JAX rounds on the same inputs.  Int32 values (the
scaled integer lattice) mask with ``INT_SENTINEL`` instead of ``-inf``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..solution import UNASSIGNED
from ..utils.trace import trace_round

_INT_MAX = UNASSIGNED

#: "minus infinity" of the integer-auction mode: far below any reachable
#: profit, far above int32 overflow when combined with real values
INT_SENTINEL = -(2**30)

#: initial stalled-phase preemption horizon (rounds); doubles on each
#: preemption until the next cardinality increase
STALL_K0 = 8


class FRState(NamedTuple):
    prices: torch.Tensor         # [B, M] object prices
    profits: torch.Tensor        # [B, N] person profits (pi)
    p2o: torch.Tensor            # [B, N] int32
    o2p: torch.Tensor            # [B, M] int32
    eps: torch.Tensor            # [B] value dtype
    forward_mode: torch.Tensor   # [B] bool, True: persons bid
    since_inc: torch.Tensor      # [B] int32 rounds since a cardinality rise
    stall_k: torch.Tensor        # [B] int32 preemption horizon
    nits: torch.Tensor           # [B] int32
    nreductions: torch.Tensor    # [B] int32
    optimal_found: torch.Tensor  # [B] bool
    done: torch.Tensor           # [B] bool


_INT_FIELDS = ("p2o", "o2p", "since_inc", "stall_k", "nits", "nreductions")
_BOOL_FIELDS = ("forward_mode", "optimal_found", "done")


def _neg_inf(dtype, device) -> torch.Tensor:
    """The masking sentinel of a value dtype: ``-inf`` for floats,
    ``INT_SENTINEL`` for the integer-auction mode."""
    if dtype.is_floating_point:
        return torch.tensor(-np.inf, dtype=dtype, device=device)
    return torch.tensor(INT_SENTINEL, dtype=dtype, device=device)


def fr_init(values_t: torch.Tensor, eps, values=None) -> FRState:
    """Initial batched state: zero prices, pi = each person's max value
    (the exact profit at zero prices, so the joint invariant holds).
    ``eps`` is a scalar or a ``[B]`` tensor.  ``values [B, N, M]``, the
    person-major layout, if given, supplies the maxima along its
    contiguous rows: the same numbers, without the device workspace that
    a reduction across ``values_t``'s rows takes for one big instance."""
    b, m, n = values_t.shape
    dtype, dev = values_t.dtype, values_t.device

    def i32(v, size):
        return torch.full((size,), v, dtype=torch.int32, device=dev)

    return FRState(
        prices=torch.zeros((b, m), dtype=dtype, device=dev),
        profits=(values_t.amax(dim=1) if values is None
                 else values.amax(dim=2)),
        p2o=torch.full((b, n), _INT_MAX, dtype=torch.int32, device=dev),
        o2p=torch.full((b, m), _INT_MAX, dtype=torch.int32, device=dev),
        eps=torch.as_tensor(eps, dtype=dtype, device=dev).expand(b).clone(),
        forward_mode=torch.ones(b, dtype=torch.bool, device=dev),
        since_inc=i32(0, b),
        stall_k=i32(STALL_K0, b),
        nits=i32(0, b),
        nreductions=i32(0, b),
        optimal_found=torch.zeros(b, dtype=torch.bool, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
    )


def _iotas(vals_t):
    _, m, n = vals_t.shape
    dev = vals_t.device
    j_iota = torch.arange(m, dtype=torch.int32, device=dev)[None, :, None]
    u_iota = torch.arange(n, dtype=torch.int32, device=dev)[None, None, :]
    return j_iota, u_iota


def _forward_sub(vals_t, prices, profits, p2o, o2p, eps, done):
    """Unassigned persons bid for objects (``done [B]`` masks finished
    or inactive instances)."""
    neg_inf = _neg_inf(vals_t.dtype, vals_t.device)
    m = vals_t.shape[1]
    j_iota, u_iota = _iotas(vals_t)

    unassigned = (p2o == _INT_MAX) & ~done[:, None]
    profit = vals_t - prices[:, :, None]
    best = profit.amax(dim=1)                                  # [B, N]
    is_best = profit == best[:, None, :]
    best_j = torch.where(is_best, j_iota, m).amin(dim=1)
    sel = j_iota == best_j[:, None, :]
    second = torch.where(sel, neg_inf, profit).amax(dim=1)
    has_second = second != neg_inf
    # profit the winner retains; price increment = best - floor + eps
    floor = torch.where(has_second, second, best)
    raw_inc = best - floor + eps[:, None]

    bidding = unassigned & (best != neg_inf)
    inc = torch.where(bidding, raw_inc, neg_inf)

    # conflict resolution per object (smallest person id wins ties)
    is_here = sel & bidding[:, None, :]
    eff = torch.where(is_here, inc[:, None, :], neg_inf)
    max_inc = eff.amax(dim=2)                                  # [B, M]
    has_winner = max_inc != neg_inf
    cand = torch.where(
        is_here & (eff >= max_inc[:, :, None]), u_iota, _INT_MAX
    )
    winner = cand.amin(dim=2)

    prices_new = torch.where(has_winner, prices + max_inc, prices)
    o2p_new = torch.where(has_winner, winner, o2p)

    # won (bit 0) and displaced (bit 1) in one coded f32 reduction
    t_won = is_here & (winner[:, :, None] == u_iota)
    t_disp = (p2o[:, None, :] == j_iota) & has_winner[:, :, None]
    code = (t_won.float() + 2.0 * t_disp.float()).sum(dim=1)
    won = (code == 1.0) | (code == 3.0)
    displaced = (p2o != _INT_MAX) & (code >= 2.0)
    p2o_new = torch.where(
        won, best_j, torch.where(displaced, _INT_MAX, p2o)
    )
    # winner's dual: pi = floor - eps, making pi + p = a exact
    profits_new = torch.where(won, floor - eps[:, None], profits)
    return prices_new, profits_new, p2o_new, o2p_new


def _reverse_sub(vals_t, prices, profits, p2o, o2p, eps, done):
    """Unassigned objects bid for persons by cutting their own price
    (the mirror of :func:`_forward_sub` on the transpose)."""
    neg_inf = _neg_inf(vals_t.dtype, vals_t.device)
    n = vals_t.shape[2]
    j_iota, u_iota = _iotas(vals_t)

    free_obj = (o2p == _INT_MAX) & ~done[:, None]
    rprof = vals_t - profits[:, None, :]                       # [B, M, N]
    beta = rprof.amax(dim=2)                                   # [B, M]
    is_beta = rprof == beta[:, :, None]
    best_i = torch.where(is_beta, u_iota, n).amin(dim=2)
    rsel = u_iota == best_i[:, :, None]
    gamma = torch.where(rsel, neg_inf, rprof).amax(dim=2)
    has_gamma = gamma != neg_inf
    rfloor = torch.where(has_gamma, gamma, beta)
    pi_inc = beta - rfloor + eps[:, None]

    bidding = free_obj & (beta != neg_inf)
    rinc = torch.where(bidding, pi_inc, neg_inf)

    # conflict resolution per person (smallest object id wins ties)
    is_here = rsel & bidding[:, :, None]
    eff = torch.where(is_here, rinc[:, :, None], neg_inf)
    max_inc = eff.amax(dim=1)                                  # [B, N]
    has_rw = max_inc != neg_inf
    cand = torch.where(
        is_here & (eff >= max_inc[:, None, :]), j_iota, _INT_MAX
    )
    winner_obj = cand.amin(dim=1)

    # won_obj (bit 0) and freed (bit 1) in one coded f32 reduction
    t_won = is_here & (winner_obj[:, None, :] == j_iota)
    is_disp = has_rw & (p2o != _INT_MAX)
    t_freed = (p2o[:, None, :] == j_iota) & is_disp[:, None, :]
    code = (t_won.float() + 2.0 * t_freed.float()).sum(dim=2)
    won_obj = (code == 1.0) | (code == 3.0)                    # [B, M]
    freed = code >= 2.0
    # winner cuts its price; pi + p = a exact for the new pair
    prices_new = torch.where(won_obj, rfloor - eps[:, None], prices)
    profits_new = torch.where(has_rw, profits + max_inc, profits)
    o2p_new = torch.where(
        won_obj, best_i, torch.where(freed, _INT_MAX, o2p)
    )
    p2o_new = torch.where(has_rw, winner_obj, p2o)
    return prices_new, profits_new, p2o_new, o2p_new


def fr_round(
    vals_t: torch.Tensor,
    s: FRState,
    target_eps,
    toleration,
    max_iterations: int,
    scale_factor: float = 0.15,
    skip_certificate: bool = False,
    trace: bool = True,
) -> FRState:
    """One forward-reverse round of every instance, with the JAX
    package's ε-scaling bookkeeping.  A no-op for instances whose
    ``done`` is set.

    ``skip_certificate=True`` is the no-ladder mode (start ε == target
    ε): a full assignment is the certificate.  Otherwise the ε-CS
    certificate runs every round and, on a full but not yet certified
    assignment, ε shrinks by ``scale_factor`` with keep-valid pair
    retention (released persons free their objects; profits are
    refreshed to the exact max profit).  ``trace=False`` leaves out the
    round's trace line: the kernels' plain versions print the kernel's
    rows instead (``ops/round_log.py``)."""
    dtype, dev = s.prices.dtype, s.prices.device
    if not dtype.is_floating_point and not skip_certificate:
        # the integer-auction mode has no fractional ε-ladder
        raise ValueError(
            "integer-auction FR rounds require skip_certificate=True"
        )
    prices, profits, p2o, o2p = _forward_sub(
        vals_t, s.prices, s.profits, s.p2o, s.o2p, s.eps,
        s.done | ~s.forward_mode,
    )
    prices, profits, p2o, o2p = _reverse_sub(
        vals_t, prices, profits, p2o, o2p, s.eps,
        s.done | s.forward_mode,
    )
    increased = (p2o != _INT_MAX).sum(dim=1) > (s.p2o != _INT_MAX).sum(dim=1)
    stall_flip = ~increased & (s.since_inc + 1 >= s.stall_k) & ~s.done
    forward_mode = s.forward_mode ^ ((increased | stall_flip) & ~s.done)
    # since_inc is frozen once done, like every other carried field
    since_inc = torch.where(
        s.done, s.since_inc,
        torch.where(increased | stall_flip, 0, s.since_inc + 1),
    )
    stall_k = torch.where(
        increased,
        STALL_K0,
        torch.where(stall_flip, s.stall_k * 2, s.stall_k),
    )
    nits = s.nits + (~s.done).to(torch.int32)
    num_unassigned = (p2o == _INT_MAX).sum(dim=1)
    fully = (num_unassigned == 0) & ~s.done
    if trace:
        trace_round(
            "fr round {}: unassigned={} forward={} eps={}",
            nits, num_unassigned, forward_mode, s.eps,
        )

    if skip_certificate:
        return FRState(
            prices=prices,
            profits=profits,
            p2o=p2o,
            o2p=o2p,
            eps=s.eps,
            forward_mode=forward_mode,
            since_inc=since_inc,
            stall_k=stall_k,
            nits=nits,
            nreductions=s.nreductions,
            optimal_found=s.optimal_found | fully,
            done=s.done | fully | (nits >= max_iterations),
        )

    # ε-CS certificate at the current prices
    target = torch.as_tensor(target_eps, dtype=dtype, device=dev)
    tol = torch.as_tensor(toleration, dtype=dtype, device=dev)
    neg_inf = _neg_inf(dtype, dev)
    j_iota, _ = _iotas(vals_t)
    profit = vals_t - prices[:, :, None]
    max_profit = profit.amax(dim=1)                            # [B, N]
    is_chosen = p2o[:, None, :] == j_iota
    chosen_profit = torch.where(is_chosen, profit, neg_inf).amax(dim=1)
    is_optimal = (chosen_profit + tol >= max_profit - target).all(dim=1)
    stop = is_optimal | (s.eps < target)
    reduce = fully & ~stop
    eps = torch.where(
        reduce, s.eps * torch.tensor(scale_factor, dtype=dtype), s.eps
    )

    # keep-valid pair retention at the reduced eps
    keep = (p2o != _INT_MAX) & (
        chosen_profit + tol >= max_profit - eps[:, None]
    )
    release = reduce[:, None] & ~keep
    freed = (is_chosen & release[:, None, :]).any(dim=2)       # [B, M]
    p2o = torch.where(release, _INT_MAX, p2o)
    o2p = torch.where(reduce[:, None] & freed, _INT_MAX, o2p)
    profits = torch.where(reduce[:, None], max_profit, profits)

    # a fresh ε-phase re-auctions released persons: forward mode, fresh
    # preemption horizon
    return FRState(
        prices=prices,
        profits=profits,
        p2o=p2o,
        o2p=o2p,
        eps=eps,
        forward_mode=forward_mode | reduce,
        since_inc=torch.where(reduce, 0, since_inc),
        stall_k=torch.where(reduce, STALL_K0, stall_k),
        nits=nits,
        nreductions=s.nreductions + reduce.to(torch.int32),
        optimal_found=s.optimal_found | (fully & is_optimal),
        done=s.done | (fully & stop) | (nits >= max_iterations),
    )


def weights_from_jax_state(np_fields: dict, device=None) -> FRState:
    """A batched :class:`FRState` from the JAX package's ``FRState``
    fields given as numpy arrays (``{"prices": ..., "p2o": ..., ...}``).
    This system has no weights: the carried auction state is what moves
    between the two packages.  ``device=None`` means ``"cuda"``."""
    dev = resolve_device(device)
    out = {}
    for name in FRState._fields:
        arr = np.array(np_fields[name])  # a writable copy
        if name in _INT_FIELDS:
            arr = arr.astype(np.int32)
        elif name in _BOOL_FIELDS:
            arr = arr.astype(bool)
        out[name] = torch.from_numpy(arr).to(dev)
    return FRState(**out)


def state_to_numpy(state: FRState) -> dict:
    """The inverse of :func:`weights_from_jax_state`: every field as a
    numpy array, keyed by field name."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in FRState._fields
    }
