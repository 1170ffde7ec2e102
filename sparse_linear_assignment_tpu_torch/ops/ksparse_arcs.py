"""Multi-round batched-sparse Khosla kernel over arc rows
(``csrc/ksp_arcs_kernel.cu``).

Replaces no TPU kernel.  The JAX package's Pallas kernel
(``ops/pallas_ksparse.py:_ksp_kernel``) and the port's plane kernel
(``ops/ksparse_kernel.py``) both run on a densified person-major plane,
one value per object in every person's row, with the per-object state in
on-chip memory.  :func:`ksp_arcs_chunk` runs the same rounds, up to
``rounds`` of ``ops/auction.py:khosla_round`` on every instance, from
each person's arcs: ``columns [B, N, K]`` int32 (``-1`` pads) and
``values [B, N, K]``, sign-adjusted as the plane is.  No plane is built.
Rounds, prices, ``p2o``, ``dropped`` and ``nits`` are bit-equal to
:func:`~.ksparse_kernel.ksp_chunk_reference` on the densified plane of
the same arcs: the best object is the smallest column among equal
profits whatever the slot order, a column listed twice keeps its later
slot's value, a single-arc person bids ``price + eps``, the price at the
best object is reconstructed as ``best_val - best`` (what the drop test
against ``thresholds [B]`` and the single-arc bid use), and the largest
bid wins an object, the smallest person among equal bids.  ``o2p``
passes through unchanged.

What bounds it on an H100.  The reference crate's asymmetric bench
(2,000 persons, 60,000 objects, 32 arcs a person) holds 512 KB of arcs
an instance; its compacted plane is 315 MB and needs ``12 M' + 17 N`` =
507 KB of shared memory, more than a block has.  The arcs are read once
in the first round and a few rows after; the per-object state (prices
and one 64-bit key an object, 720 KB an instance) stays in device memory
and is gathered from L2.  A round is a chain of dependent accesses (the
row, its prices, the bid's atomic; then the apply pass's key), so the
kernel is bound by their latency, not by bytes.  The design:

- one CTA of 256 threads per instance, 4 resident on an SM; ``p2o`` and
  ``dropped`` updated in place, two active lists and the round's targets
  in a device scratch (12 bytes a person, 24 in float64), so any N runs;
- one warp per active person, four persons a warp at once: a lane loads
  one arc slot of each (a 32-arc row is one 128-byte load of columns and
  one of values), so four rows, then their 128 price gathers, are in
  flight before any is folded; the top-2 with the smallest-column tie
  rule (``csrc/fr_common.cuh``'s warp merge), a repeated column found
  with one ``__match_any_sync``; one 64-bit ``atomicMax`` posts a bid;
- between rounds a key rests at its object's owner, so the one bid that
  finds it at rest displaces the owner, and the apply pass walks only
  the round's entries: two barriers a round.

``phase_cycles`` splits the leader thread's cycles by phase
(``ksparse_kernel.PHASES``); ``stamps`` gives each CTA's start and end;
with tracing on (``SLAP_TPU_DEBUG``) or ``trace_rows`` given, each CTA's
thread 0 logs one row a round (``ops/round_log.py``, JAX's
``KSP_FORMAT``).  float32 and float64 values each have a kernel
instance: float64, which the staging entry points take where float32
cannot resolve ``eps`` (:func:`resolves`), cannot pack the bidder beside
its bid in one 64-bit key, so its keys hold the bid alone and a pass
more a round (one barrier) lets the bidders of an object's largest bid
post their indices with ``atomicMin``.  Limits: ``K >= 1``, ``p2o`` a
matching.

On CPU tensors :func:`ksp_arcs_chunk` runs the plain PyTorch version
:func:`ksp_arcs_chunk_reference`; on CUDA tensors it launches the kernel
or raises.  ``LAUNCHES`` counts the launches.

The ε-scaling ladder (:func:`ksp_arcs_ladder`, plain version
:func:`ksp_arcs_ladder_reference`; ``LADDER_LAUNCHES``): the same rounds
in phases of shrinking ε, each instance's phases back to back in its CTA
(``ksp_arcs_ladder_kernel``), with its state between launches in a
:class:`Ladder`.  A square batch at a small ε is a price war that a
single ε ends only after about (value span)/ε exchanges; the ladder ends
the reference crate's config A (10,000², ε = 2^-15/10,001) in 14,000 to
61,000 rounds an instance.  Its rows hold each column once
(:func:`distinct_columns`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..solution import UNASSIGNED
from ..utils.trace import is_enabled
from . import _build, round_log
from .auction import KhoslaState
from .fr_kernel import check_counters
from .ksparse_kernel import PHASES

#: kernel launches made by :func:`ksp_arcs_chunk` in this process
LAUNCHES = 0

#: kernel launches made by :func:`ksp_arcs_ladder` in this process
LADDER_LAUNCHES = 0

#: the ladder's step shrinks by this factor from phase to phase
#: (``ops/compact.py:khosla_solve_scaled``'s ``reduction_factor``)
LADDER_FACTOR = 0.125

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ksp_arcs_kernel")
        p = ctypes.c_void_p
        lib.slap_ksp_arcs_rounds.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, p, p, p, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, p,
        ]
        lib.slap_ksp_arcs_rounds.restype = ctypes.c_int
        lib.slap_ksp_arcs_ladder.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, p, p, p, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
        ]
        lib.slap_ksp_arcs_ladder.restype = ctypes.c_int
        lib.slap_ksp_arcs_error_string.argtypes = [ctypes.c_int]
        lib.slap_ksp_arcs_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def resolves(eps, absmax) -> bool:
    """Whether float32 keeps ``eps`` in a profit ``value - price`` of an
    instance whose largest ``|value|`` is ``absmax``: ``eps`` at least
    float32's spacing at twice that magnitude (room for prices as large
    as the values).  Below it the rounding can swallow a price's last
    ``eps``: two persons whose best and second profits then tie take one
    object from each other at the same price, round after round, in the
    plane's float32 rounds as in these (2,000 x 60,000 with values in
    [300, 1000) and ``eps = 1/60,000``: about 3% of instances).  The
    staging entry points' arc route then runs in float64."""
    absmax = float(absmax)
    if absmax <= 0.0:
        return True
    return float(eps) >= float(np.spacing(np.float32(2.0 * absmax)))


def arcs_init(values: torch.Tensor, m: int) -> KhoslaState:
    """Initial batched state of arcs ``values [B, N, K]`` over ``m``
    objects: zero prices, nobody assigned or dropped."""
    b, n, _ = values.shape
    dev = values.device
    return KhoslaState(
        prices=torch.zeros((b, m), dtype=values.dtype, device=dev),
        p2o=torch.full((b, n), UNASSIGNED, dtype=torch.int32, device=dev),
        o2p=torch.full((b, m), UNASSIGNED, dtype=torch.int32, device=dev),
        dropped=torch.zeros((b, n), dtype=torch.bool, device=dev),
        nits=torch.zeros(b, dtype=torch.int32, device=dev),
    )


def check_arcs(columns, values, states: KhoslaState, thresholds) -> None:
    """Raise unless ``columns`` (int32) and ``values`` (float) are
    ``[B, N, K]`` arcs with ``K >= 1`` and ``states`` and ``thresholds``
    are batched of their shape and device."""
    if values.dim() != 3 or tuple(columns.shape) != tuple(values.shape):
        raise ValueError("columns and values must both be [B, N, K]")
    if columns.dtype != torch.int32:
        raise ValueError(f"columns must be int32, got {columns.dtype}")
    if not values.dtype.is_floating_point:
        raise ValueError(f"ksp_arcs_chunk takes float values, got "
                         f"{values.dtype}")
    b, n, k = values.shape
    if k < 1:
        raise ValueError("the arcs need at least one slot a person")
    m = states.prices.shape[-1]
    for name, t, want in (
        ("columns", columns, (b, n, k)),
        ("states.prices", states.prices, (b, m)),
        ("states.p2o", states.p2o, (b, n)),
        ("states.o2p", states.o2p, (b, m)),
        ("states.dropped", states.dropped, (b, n)),
        ("states.nits", states.nits, (b,)),
        ("thresholds", thresholds, (b,)),
    ):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, values on "
                             f"{values.device}")


def _check_act_rows(act_rows, b: int, device) -> None:
    if act_rows is not None and (
        act_rows.dtype != torch.int64 or tuple(act_rows.shape) != (b,)
        or act_rows.device != device or not act_rows.is_contiguous()
    ):
        raise ValueError("act_rows must be a contiguous int64 [B] tensor "
                         "on the values' device")


def later_repeat(columns: torch.Tensor) -> torch.Tensor:
    """``[B, N, K]`` bool: the slot's column is repeated by a later slot
    of its row (the plane keeps the later slot's value, so this one is
    no arc).  A stable sort puts a row's equal columns side by side in
    slot order."""
    ordered, at = columns.sort(dim=2, stable=True)
    repeated = torch.zeros_like(columns, dtype=torch.bool)
    repeated[:, :, :-1] = ordered[:, :, :-1] == ordered[:, :, 1:]
    return torch.zeros_like(repeated).scatter_(2, at, repeated)


def _arcs_round(columns, values, valid, s: KhoslaState, eps,
                thresholds) -> KhoslaState:
    """One synchronous Khosla round of every instance from its arcs,
    with the densified plane's arithmetic (``ops/auction.py``'s
    ``_top2_profits_dense`` and ``_resolve_and_assign_dense``) over the
    rows of the active persons alone: an instance with no active person
    comes out unchanged.  ``eps`` is a scalar or one a instance
    (``[B]``)."""
    b, n, _ = values.shape
    m = s.prices.shape[1]
    dtype, dev = values.dtype, values.device
    neg_inf = torch.full((), -float("inf"), dtype=dtype, device=dev)
    big = torch.iinfo(torch.int32).max

    active = (s.p2o == UNASSIGNED) & ~s.dropped
    inst, person = active.nonzero(as_tuple=True)
    cols, vals, ok = columns[inst, person], values[inst, person], \
        valid[inst, person]
    safe = torch.where(ok, cols, 0).long()
    profit = torch.where(ok, vals - s.prices[inst[:, None], safe], neg_inf)
    best = profit.amax(dim=1)
    best_col = torch.where(ok & (profit == best[:, None]), cols,
                           big).amin(dim=1)
    sel = ok & (cols == best_col[:, None])
    second = torch.where(sel, neg_inf, profit).amax(dim=1)
    best_val = torch.where(sel, vals, neg_inf).amax(dim=1)
    price_at_best = best_val - best
    drop_now = price_at_best > thresholds[inst]
    if eps.dim() > 0:
        eps = eps[inst]
    raw_bid = torch.where(second != neg_inf, best_val - second + eps,
                          price_at_best + eps)
    bid = torch.where(drop_now, neg_inf, raw_bid)

    # each object takes the largest bid, the smallest person on ties; a
    # person that drops aims at its instance's dummy column m
    target = inst * (m + 1) + torch.where(drop_now, m, best_col).long()
    max_bid = torch.full((b * (m + 1),), -float("inf"), dtype=dtype,
                         device=dev)
    max_bid.scatter_reduce_(0, target, bid, "amax")
    top = ~drop_now & (bid == max_bid[target])
    person = person.to(torch.int32)
    winner = torch.full((b * (m + 1),), big, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, target, torch.where(top, person, big), "amin")
    won = ~drop_now & (winner[target] == person)
    max_bid = max_bid.view(b, m + 1)[:, :m]
    has_winner = max_bid != neg_inf
    assigned = s.p2o != UNASSIGNED
    displaced = assigned & has_winner.gather(
        1, torch.where(assigned, s.p2o, 0).long())
    p2o = torch.where(displaced, UNASSIGNED, s.p2o).to(torch.int32)
    p2o[inst[won], person[won].long()] = best_col[won].to(torch.int32)
    dropped = s.dropped.clone()
    dropped[inst, person.long()] = drop_now
    return KhoslaState(
        prices=torch.where(has_winner, max_bid, s.prices),
        p2o=p2o,
        o2p=s.o2p,
        dropped=dropped,
        nits=s.nits + active.any(dim=1).to(torch.int32),
    )


def ksp_arcs_chunk_reference(columns, values, states: KhoslaState, eps,
                             thresholds, rounds: int, act_rows=None,
                             trace_rows=None) -> KhoslaState:
    """Plain PyTorch version of the kernel: a loop of synchronous rounds
    over the arcs, stopped once no instance has an active person.  Any
    float dtype.  ``act_rows [B]`` int64, if given, gains the number of
    active persons' rows each instance read; ``trace_rows`` receives the
    kernel's round trace (:func:`ksp_arcs_chunk`)."""
    check_arcs(columns, values, states, thresholds)
    b = values.shape[0]
    width = len(round_log.KSP_FIELDS)
    _check_act_rows(act_rows, b, values.device)
    round_log.check_rows(trace_rows, b, rounds, width, values.device)
    log = trace_rows is not None or is_enabled()
    eps = torch.as_tensor(eps, dtype=values.dtype, device=values.device)
    thresholds = thresholds.to(values.dtype)
    valid = (columns >= 0) & ~later_repeat(columns)
    rows = []
    s = states
    for _ in range(rounds):
        active = (s.p2o == UNASSIGNED) & ~s.dropped
        if not bool(active.any()):
            break
        if act_rows is not None:
            act_rows += active.sum(dim=1)
        s = _arcs_round(columns, values, valid, s, eps, thresholds)
        if log:
            left = ((s.p2o == UNASSIGNED) & ~s.dropped).any(dim=1)
            row = torch.stack([s.nits, left, ~left], dim=1).to(torch.int32)
            rows.append(torch.where(active.any(dim=1)[:, None], row, 0))
    if log:
        round_log.plain_rows(rows, trace_rows, round_log.KSP_FORMAT,
                             s.nits - states.nits, b, width, values.device)
    return s


def ksp_arcs_chunk(columns, values, states: KhoslaState, eps, thresholds,
                   rounds: int, act_rows=None, phase_cycles=None,
                   stamps=None, trace_rows=None) -> KhoslaState:
    """Up to ``rounds`` fused Khosla rounds over a batched
    :class:`KhoslaState` from the arcs ``columns [B, N, K]`` (int32,
    ``-1`` pads) and ``values [B, N, K]`` (float32 or float64,
    sign-adjusted) over the ``M`` objects of ``states.prices [B, M]``.
    ``eps`` is a scalar,
    ``thresholds [B]`` the drop thresholds.  Every person needs at least
    one arc: the staging functions check it.  CPU tensors run
    :func:`ksp_arcs_chunk_reference`; CUDA tensors launch the kernel.

    Round trace, ``phase_cycles`` and ``stamps`` as
    :func:`~.ksparse_kernel.ksp_chunk` takes them."""
    check_arcs(columns, values, states, thresholds)
    check_counters(values, len(PHASES), phase_cycles, stamps)
    b = values.shape[0]
    round_log.check_rows(trace_rows, b, rounds, len(round_log.KSP_FIELDS),
                         values.device)
    if values.device.type == "cpu":
        return ksp_arcs_chunk_reference(columns, values, states, eps,
                                        thresholds, rounds, act_rows,
                                        trace_rows)
    if values.device.type != "cuda":
        raise ValueError(f"ksp_arcs_chunk runs on cpu or cuda, not "
                         f"{values.device}")
    return round_log.launch_traced(
        lambda s, r, log: _ksp_arcs_chunk_cuda(
            columns, values, s, eps, thresholds, r, act_rows, phase_cycles,
            stamps, log),
        states, rounds, trace_rows, round_log.KSP_FORMAT, b,
        len(round_log.KSP_FIELDS), values.device, lambda s: s.nits,
    )


def _ksp_arcs_chunk_cuda(columns, values, states, eps, thresholds, rounds,
                         act_rows, phase_cycles, stamps, log):
    """The launch, float32 or float64."""
    global LAUNCHES
    b, n, k = values.shape
    m = states.prices.shape[1]
    dtype = values.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the arc Khosla kernel takes float32 or float64 "
                         f"values, got {dtype}; other types run "
                         f"ksp_arcs_chunk_reference")
    _check_act_rows(act_rows, b, values.device)
    dev = values.device
    cols = columns.contiguous()
    vals = values.contiguous()
    prices = states.prices.to(dtype).contiguous().clone()
    p2o = states.p2o.to(torch.int32).contiguous().clone()
    dropped = states.dropped.to(torch.bool).contiguous().clone()
    nits = states.nits.to(torch.int32).contiguous().clone()
    thr = thresholds.to(dtype).contiguous()
    keys = torch.zeros((b, m), dtype=torch.int64, device=dev)
    double = dtype == torch.float64
    winner = (torch.empty((b, m), dtype=torch.int32, device=dev) if double
              else None)
    scratch = torch.empty((b, (6 if double else 3) * n), dtype=torch.int32,
                          device=dev)
    lib = _kernel_lib()
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slap_ksp_arcs_rounds(
            cols.data_ptr(), vals.data_ptr(), prices.data_ptr(),
            keys.data_ptr(), ptr(winner), p2o.data_ptr(), dropped.data_ptr(),
            nits.data_ptr(), thr.data_ptr(), scratch.data_ptr(),
            ptr(act_rows), ptr(phase_cycles), ptr(stamps), ptr(log),
            float(eps), 8 if double else 4, b, n, m, k, int(rounds), stream,
        )
    if rc != 0:
        msg = lib.slap_ksp_arcs_error_string(rc).decode()
        raise RuntimeError(f"arc Khosla kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return KhoslaState(prices=prices, p2o=p2o, o2p=states.o2p,
                       dropped=dropped, nits=nits)


class Ladder(NamedTuple):
    """An ε-scaling ladder's state beside the batch's
    :class:`KhoslaState` (:func:`ksp_arcs_ladder`), one entry an
    instance."""

    spans: torch.Tensor       # [B] float64: the staged values' span
    steps: torch.Tensor       # [B] float64: the current phase's step
    thresholds: torch.Tensor  # [B], the values' dtype: its drop threshold
    phase: torch.Tensor       # [B] int32: the current phase
    rounds: torch.Tensor      # [B, P] int32: the rounds run in each phase


def ladder_steps(span: float, eps_target: float) -> list:
    """The ε of each phase of a square instance whose values span
    ``span``: from ``max(span / 4, eps_target)`` down by
    :data:`LADDER_FACTOR` while above ``eps_target``, then
    ``eps_target`` (``ops/compact.py:khosla_solve_scaled``)."""
    eps = max(span / 4.0, eps_target)
    steps = []
    while eps > eps_target:
        steps.append(eps)
        eps *= LADDER_FACTOR
    return steps + [eps_target]


def ladder_init(spans, eps_target: float, m: int, dtype,
                device) -> Ladder:
    """The ladder of a batch from the initial state: each instance at
    its first phase, whose drop threshold is ``(m / 2)(span + ε)`` in
    float64 rounded once to ``dtype``, and room for the longest
    instance's phases.  ``spans`` is a host float64 array."""
    spans = np.asarray(spans, dtype=np.float64)
    steps = np.maximum(spans / 4.0, eps_target)
    phases = max(len(ladder_steps(float(x), eps_target)) for x in spans)
    thresholds = (m / 2.0) * (spans + steps) + 0.0
    return Ladder(
        spans=torch.from_numpy(spans).to(device),
        steps=torch.from_numpy(steps).to(device),
        thresholds=torch.from_numpy(thresholds).to(device, dtype),
        phase=torch.zeros(len(spans), dtype=torch.int32, device=device),
        rounds=torch.zeros((len(spans), phases), dtype=torch.int32,
                           device=device),
    )


def distinct_columns(columns: torch.Tensor) -> torch.Tensor:
    """``columns`` with every slot whose column a later slot of its row
    repeats set to ``-1``: the same arcs as the plane keeps them (a
    repeated column's later slot), each column once a row, as
    :func:`ksp_arcs_ladder` takes them."""
    return torch.where(later_repeat(columns), -1, columns)


def _check_ladder(values, ladder: Ladder) -> None:
    b = values.shape[0]
    for name, t, dtype in (("spans", ladder.spans, torch.float64),
                           ("steps", ladder.steps, torch.float64),
                           ("thresholds", ladder.thresholds, values.dtype),
                           ("phase", ladder.phase, torch.int32)):
        if tuple(t.shape) != (b,) or t.dtype != dtype:
            raise ValueError(f"ladder.{name} must be a {dtype} [{b}] tensor")
    r = ladder.rounds
    if r.dim() != 2 or r.shape[0] != b or r.shape[1] < 1 or (
            r.dtype != torch.int32):
        raise ValueError(f"ladder.rounds must be an int32 [{b}, P] tensor")
    for t in ladder:
        if t.device != values.device:
            raise ValueError(f"the ladder is on {t.device}, the values on "
                             f"{values.device}")


def ksp_arcs_ladder_reference(columns, values, states: KhoslaState,
                              ladder: Ladder, eps_target: float, m: int,
                              rounds: int):
    """Plain PyTorch version of the ladder kernel: synchronous rounds
    over the batch, each instance at its own phase's ε and threshold;
    right after the round that leaves an instance with no active person,
    unless that phase ran at ``eps_target``, the step shrinks by
    :data:`LADDER_FACTOR`, the threshold becomes ``(m / 2)(span + ε) +
    max(0, the largest price)`` in float64 rounded once, and the
    matching and the drops are reset, prices kept.  At most ``rounds``
    rounds; any float dtype; repeated columns as the plane keeps them.
    Returns ``(states, ladder)``."""
    check_arcs(columns, values, states, ladder.thresholds)
    _check_ladder(values, ladder)
    b = values.shape[0]
    dtype, dev = values.dtype, values.device
    valid = (columns >= 0) & ~later_repeat(columns)
    rows = torch.arange(b, device=dev)
    target = torch.full((b,), eps_target, dtype=torch.float64, device=dev)
    s, lad = states, ladder._replace(rounds=ladder.rounds.clone())
    for _ in range(rounds):
        busy = ((s.p2o == UNASSIGNED) & ~s.dropped).any(dim=1)
        if not bool(busy.any()):
            break
        eps = torch.where(lad.steps > target, lad.steps, target).to(dtype)
        s = _arcs_round(columns, values, valid, s, eps, lad.thresholds)
        at = lad.phase.long().clamp(max=lad.rounds.shape[1] - 1)
        lad.rounds[rows, at] += (busy & (lad.phase < lad.rounds.shape[1])
                                 ).to(torch.int32)
        left = ((s.p2o == UNASSIGNED) & ~s.dropped).any(dim=1)
        nxt = busy & ~left & (lad.steps > target)
        if not bool(nxt.any()):
            continue
        steps = torch.where(nxt, lad.steps * LADDER_FACTOR, lad.steps)
        pad = s.prices.amax(dim=1).to(torch.float64).clamp(min=0.0)
        eps_next = torch.where(steps > target, steps, target)
        thr = ((m / 2.0) * (lad.spans + eps_next) + pad).to(dtype)
        lad = lad._replace(
            steps=steps, thresholds=torch.where(nxt, thr, lad.thresholds),
            phase=lad.phase + nxt.to(torch.int32))
        s = s._replace(
            p2o=torch.where(nxt[:, None], UNASSIGNED, s.p2o).to(torch.int32),
            dropped=s.dropped & ~nxt[:, None])
    return s, lad


def ksp_arcs_ladder(columns, values, states: KhoslaState, ladder: Ladder,
                    eps_target: float, m: int, rounds: int):
    """Up to ``rounds`` rounds of each instance's ε-scaling ladder, its
    phases back to back (:func:`ksp_arcs_ladder_reference` gives the
    rules), from the arcs ``columns [B, N, K]`` (int32, ``-1`` pads,
    each column at most once a row: :func:`distinct_columns`) and
    ``values [B, N, K]`` (float32 or float64, sign-adjusted) over the
    objects of ``states.prices``; ``m`` is the object count of the drop
    thresholds.  Returns ``(states, ladder)``: an instance with an
    active person after it is mid-phase, and a later call continues it.
    CPU tensors run the plain version; CUDA tensors launch
    ``ksp_arcs_ladder_kernel``, one CTA an instance."""
    check_arcs(columns, values, states, ladder.thresholds)
    _check_ladder(values, ladder)
    if values.device.type == "cpu":
        return ksp_arcs_ladder_reference(columns, values, states, ladder,
                                         eps_target, m, rounds)
    if values.device.type != "cuda":
        raise ValueError(f"ksp_arcs_ladder runs on cpu or cuda, not "
                         f"{values.device}")
    global LADDER_LAUNCHES
    b, n, k = values.shape
    width = states.prices.shape[1]
    dtype, dev = values.dtype, values.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the ladder kernel takes float32 or float64 "
                         f"values, got {dtype}; other types run "
                         f"ksp_arcs_ladder_reference")
    cols = columns.contiguous()
    vals = values.contiguous()
    prices = states.prices.to(dtype).contiguous().clone()
    p2o = states.p2o.to(torch.int32).contiguous().clone()
    dropped = states.dropped.to(torch.bool).contiguous().clone()
    nits = states.nits.to(torch.int32).contiguous().clone()
    lad = Ladder(*(t.contiguous().clone() for t in ladder))
    keys = torch.zeros((b, width), dtype=torch.int64, device=dev)
    double = dtype == torch.float64
    winner = (torch.empty((b, width), dtype=torch.int32, device=dev)
              if double else None)
    scratch = torch.empty((b, (6 if double else 3) * n), dtype=torch.int32,
                          device=dev)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slap_ksp_arcs_ladder(
            cols.data_ptr(), vals.data_ptr(),
            prices.data_ptr(), keys.data_ptr(), ptr(winner),
            p2o.data_ptr(), dropped.data_ptr(), nits.data_ptr(),
            lad.thresholds.data_ptr(), scratch.data_ptr(),
            lad.spans.data_ptr(), lad.steps.data_ptr(), lad.phase.data_ptr(),
            lad.rounds.data_ptr(), lad.rounds.shape[1], float(eps_target),
            m / 2.0, 8 if double else 4, b, n, width, k, int(rounds), stream,
        )
    if rc != 0:
        msg = lib.slap_ksp_arcs_error_string(rc).decode()
        raise RuntimeError(f"arc ladder kernel launch failed: {msg} ({rc})")
    LADDER_LAUNCHES += 1
    return KhoslaState(prices=prices, p2o=p2o, o2p=states.o2p,
                       dropped=dropped, nits=nits), lad
