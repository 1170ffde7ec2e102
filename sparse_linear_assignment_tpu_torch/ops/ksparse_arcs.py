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
"""

from __future__ import annotations

import ctypes

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
    ``_top2_profits_dense`` and ``_resolve_and_assign_dense``): an
    instance with no active person comes out unchanged."""
    b, n, _ = values.shape
    m = s.prices.shape[1]
    dtype, dev = values.dtype, values.device
    neg_inf = torch.full((), -float("inf"), dtype=dtype, device=dev)
    big = torch.iinfo(torch.int32).max

    active = (s.p2o == UNASSIGNED) & ~s.dropped
    safe = torch.where(valid, columns, 0).long()
    profit = torch.where(
        valid, values - s.prices.gather(1, safe.reshape(b, -1)).reshape(
            safe.shape), neg_inf)
    best = profit.amax(dim=2)
    best_col = torch.where(valid & (profit == best[:, :, None]), columns,
                           big).amin(dim=2)
    sel = valid & (columns == best_col[:, :, None])
    second = torch.where(sel, neg_inf, profit).amax(dim=2)
    best_val = torch.where(sel, values, neg_inf).amax(dim=2)
    price_at_best = best_val - best
    drop_now = active & (price_at_best > thresholds[:, None])
    bidder = active & ~drop_now
    raw_bid = torch.where(second != neg_inf, best_val - second + eps,
                          price_at_best + eps)
    bid = torch.where(bidder, raw_bid, neg_inf)

    # each object takes the largest bid, the smallest person on ties; a
    # person that bids nothing aims at the dummy column m
    target = torch.where(bidder, best_col, m).long()
    max_bid = torch.full((b, m + 1), -float("inf"), dtype=dtype, device=dev)
    max_bid.scatter_reduce_(1, target, bid, "amax")
    top = bidder & (bid == max_bid.gather(1, target))
    persons = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    winner = torch.full((b, m + 1), big, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(1, target, torch.where(top, persons, big), "amin")
    has_winner = max_bid[:, :m] != neg_inf
    won = bidder & (winner.gather(1, target) == persons)
    assigned = s.p2o != UNASSIGNED
    displaced = assigned & has_winner.gather(
        1, torch.where(assigned, s.p2o, 0).long())
    p2o = torch.where(won, best_col,
                      torch.where(displaced, UNASSIGNED, s.p2o))
    return KhoslaState(
        prices=torch.where(has_winner, max_bid[:, :m], s.prices),
        p2o=p2o.to(torch.int32),
        o2p=s.o2p,
        dropped=s.dropped | drop_now,
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
