"""Multi-round forward-reverse auction kernel (``csrc/fr_kernel.cu``).

Replaces the JAX package's Pallas TPU kernel ``ops/pallas_fr.py:
_fr_kernel`` (with ``_fr_one_block``, ``_generic_sub`` and the fused
top-2 helpers), driven there by ``fr_chunk_pallas``.  ``fr_chunk`` runs
up to ``rounds`` rounds of ``ops/fr_dense.py:fr_round(skip_certificate=
True)`` on every instance that is not done, each instance leaving the
loop as soon as its matching is full.

What bounds it on an H100.  Each round of an instance reads the value
rows of its current bidders (``S`` values each) and does little
arithmetic on them: at 4096 x 256² int32 the rows read add up to 4.8 GB,
1.43 ms at 3.35 TB/s, most of it in the opening rounds, when every entry
bids.  After those, a round has a few bidders and the pace is the
latency of one round: a row load, a warp reduction, shared-memory
atomics and the block barriers, over 142 rounds for the median instance
and 810 for the slowest.  The previous design (a warp walking one
bidder's row in 4-byte loads, 8 dependent steps at 256², five barriers,
256 threads and 64 registers, so 4 instances an SM) spent two thirds of
a round's cycles in the bids.  The design against that:

- one CTA per instance, the whole instance state in shared memory for
  the whole loop, so the only device-memory traffic of a round is the
  bidders' rows (and nothing at all for finished instances, which exit
  at once);
- only unassigned bidders read their rows, one bidder a warp in 16-byte
  loads with all of the row's loads in flight (two a lane at 256²), so
  a round with a few bidders costs one load latency;
- two barriers a round, and the apply pass touches only the round's
  entries, not all ``S``: each bidder takes its item (whose old owner
  joins the next bidders) or stays a bidder, and the priced side's
  unassigned that took no bid stay listed, so both of the next round's
  lists (either mode may follow) come out of one pass; the keys and the
  control words alternate between two sets by round, and every thread
  computes the control from the same shared words;
- 128 threads (two indices a thread at 256²) and at most 40 registers
  a thread, so 12 instances of 256² are resident on an SM (1,584 on the
  card, three times the old design's) and hide each other's round
  latency; the apply pass no longer needs a thread per index;
- both layouts stay in device memory (``values_t`` object-major and its
  transpose), so a bidder's row is contiguous in either mode; the
  transpose costs one extra copy of the values.

``phase_cycles`` splits the leader thread's cycles by phase; ``stamps``
gives each CTA's start and end, the waves and the straggler; with
tracing on (``SLAP_TPU_DEBUG``) or ``trace_rows`` given, each CTA's
thread 0 logs one row a round (``ops/round_log.py``).  Limits:
``S`` a multiple of 4 (16-byte rows), ``60 S`` bytes of shared memory,
``S <= MAX_SIDE``.

On CPU tensors :func:`fr_chunk` runs the plain PyTorch version
:func:`fr_chunk_reference`; on CUDA tensors it launches the kernel or
raises.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..solution import UNASSIGNED
from ..utils.trace import is_enabled
from . import _build, round_log
from .fr_dense import FRState, fr_round

#: kernel launches made by :func:`fr_chunk` in this process
LAUNCHES = 0

#: the largest instance side the kernel takes (the fused path's limit:
#: N * M <= 1024**2 with N == M)
MAX_SIDE = 1024

#: the phase counters of ``phase_cycles``, in order: clock64 cycles of
#: each CTA's thread 0 summed over rounds and CTAs (``bids`` the row
#: loads, top-2s and bids, ``apply`` the pass over the round's entries
#: and the next lists, ``barrier_wait`` the time in block barriers,
#: ``total`` whole rounds), and the rounds counted
PHASES = ("bids", "apply", "control", "barrier_wait", "total", "rounds")

_NO_LIMIT = 2**31 - 1
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fr_kernel")
        p = ctypes.c_void_p
        lib.slap_fr_rounds.argtypes = [
            ctypes.c_int, p, p, p, p, p, p, p, p, p, p, p, p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
        ]
        lib.slap_fr_rounds.restype = ctypes.c_int
        lib.slap_cuda_error_string.argtypes = [ctypes.c_int]
        lib.slap_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_state(values_t: torch.Tensor, states: FRState) -> None:
    """Raise unless ``values_t`` is a square float32 or int32 ``[B, M, N]``
    batch and ``states`` a batched state of its shape and device."""
    if values_t.dim() != 3:
        raise ValueError("values_t must be [B, M, N]")
    b, m, n = values_t.shape
    if m != n:
        raise ValueError(f"fr_chunk needs square instances, got {m}x{n}")
    if values_t.dtype not in (torch.float32, torch.int32):
        raise ValueError(
            f"fr_chunk takes float32 or int32 values, got {values_t.dtype}"
        )
    for name, want in (
        ("prices", (b, m)), ("profits", (b, n)), ("p2o", (b, n)),
        ("o2p", (b, m)), ("eps", (b,)), ("done", (b,)),
    ):
        t = getattr(states, name)
        if tuple(t.shape) != want:
            raise ValueError(f"states.{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.device != values_t.device:
            raise ValueError(f"states.{name} is on {t.device}, values_t "
                             f"on {values_t.device}")


def fr_chunk_reference(values_t, states: FRState, rounds: int,
                       bid_rows=None, trace_rows=None):
    """Plain PyTorch version of the kernel: a loop of ``fr_round(
    skip_certificate=True)`` with the kernel's early exit.  Finished
    instances are frozen by ``fr_round`` itself, so stopping once all
    are done changes nothing.  ``bid_rows [B]`` int64, if given, gains
    the number of bidder rows each instance read (the unassigned
    entries of the bidding side, per round); ``trace_rows`` receives the
    kernel's round trace (:func:`fr_chunk`)."""
    return plain_chunk(values_t, states, rounds, bid_rows, trace_rows,
                       round_log.FR_FORMAT)


def plain_chunk(values_t, states: FRState, rounds: int, bid_rows,
                trace_rows, fmt: str):
    """The plain version of both FR kernels; ``fmt`` is the kernel's
    trace line."""
    b = values_t.shape[0]
    width = len(round_log.FR_FIELDS)
    round_log.check_rows(trace_rows, b, rounds, width, values_t.device)
    log = trace_rows is not None or is_enabled()
    rows = []
    s = states
    for _ in range(rounds):
        if bool(s.done.all()):
            break
        if bid_rows is not None:
            col = torch.where(s.forward_mode[:, None], s.p2o, s.o2p)
            bid_rows += ((col == UNASSIGNED) & ~s.done[:, None]).sum(dim=1)
        ran = ~s.done
        s = fr_round(values_t, s, 0, 0, _NO_LIMIT, skip_certificate=True,
                     trace=False)
        if log:
            row = torch.stack(
                [s.nits, s.forward_mode, (s.p2o != UNASSIGNED).sum(dim=1),
                 s.done], dim=1,
            ).to(torch.int32)
            rows.append(torch.where(ran[:, None], row, 0))
    if log:
        round_log.plain_rows(rows, trace_rows, fmt, s.nits - states.nits, b,
                             width, values_t.device)
    s = s._replace(
        eps=states.eps,
        nreductions=states.nreductions,
        optimal_found=states.optimal_found | s.done,
    )
    return s, s.done.all()


def fr_chunk(values_t, states: FRState, rounds: int, values=None,
             bid_rows=None, phase_cycles=None, stamps=None, trace_rows=None):
    """``rounds`` fused rounds over a batched :class:`FRState`; returns
    ``(states, all_done)``.

    ``values_t [B, M, N]`` (M == N <= 1024, float32 or int32 lattice);
    ``values`` is its transpose ``[B, N, M]`` if the caller already has
    it (built here otherwise).  ``eps`` and ``nreductions`` pass
    through; ``optimal_found |= done``.  CPU tensors run
    :func:`fr_chunk_reference`; CUDA tensors launch the kernel.

    Round trace: with tracing on, each instance's rounds are printed
    after the launch, one line a round in JAX's format
    (``round_log.FR_FORMAT``; ``g`` is the instance's index in the
    batch); ``trace_rows``, a contiguous int32 ``[B, rounds, 4]`` tensor
    on the values' device, receives the rows (``round_log.FR_FIELDS``
    after each round run, zero after the instance stopped), on either
    device.

    Measurement (CUDA tensors only: the plain version has no clock):
    ``phase_cycles``, a contiguous int64 tensor of ``len(PHASES)``,
    gains the kernel's phase counters; ``stamps``, a contiguous int64
    ``[B, 2]`` tensor, receives each CTA's start and end on the card's
    global timer (nanoseconds; of the last launch where a trace longer
    than ``round_log.MAX_LOG_BYTES`` runs in pieces)."""
    check_state(values_t, states)
    check_counters(values_t, len(PHASES), phase_cycles, stamps)
    b = values_t.shape[0]
    round_log.check_rows(trace_rows, b, rounds, len(round_log.FR_FIELDS),
                         values_t.device)
    if values_t.device.type == "cpu":
        return fr_chunk_reference(values_t, states, rounds, bid_rows,
                                  trace_rows)
    if values_t.device.type != "cuda":
        raise ValueError(f"fr_chunk runs on cpu or cuda, not "
                         f"{values_t.device}")
    new = round_log.launch_traced(
        lambda s, r, log: _fr_chunk_cuda(values_t, s, r, values, bid_rows,
                                         phase_cycles, stamps, log),
        states, rounds, trace_rows, round_log.FR_FORMAT, b,
        len(round_log.FR_FIELDS), values_t.device, lambda s: s.nits,
    )
    return new, new.done.all()


def check_counters(values, n_phases: int, phase_cycles, stamps) -> None:
    """Raise unless ``phase_cycles`` and ``stamps`` are each None or a
    contiguous int64 tensor (``[n_phases]``, ``[B, 2]``) on the device
    of the batch ``values``, and not on the CPU, where the plain
    versions run and have no clock."""
    b = values.shape[0]
    for name, t, shape in (("phase_cycles", phase_cycles, (n_phases,)),
                           ("stamps", stamps, (b, 2))):
        if t is None:
            continue
        if values.device.type == "cpu":
            raise ValueError(f"{name} counts the CUDA kernel's clock; the "
                             f"plain version has none")
        if (t.dtype != torch.int64 or tuple(t.shape) != shape
                or t.device != values.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int64 "
                             f"{list(shape)} tensor on the values' device")


def _fr_chunk_cuda(values_t, states, rounds, values, bid_rows, phase_cycles,
                   stamps, log):
    global LAUNCHES
    b, m, n = values_t.shape
    if n > MAX_SIDE or n % 4:
        raise ValueError(f"the FR kernel takes instances up to "
                         f"{MAX_SIDE}² with a side that is a multiple of 4 "
                         f"(16-byte rows), got {n}²")
    dtype = values_t.dtype
    vt = values_t.contiguous()
    v = (vt.transpose(1, 2) if values is None else values).contiguous()
    if v.shape != vt.shape or v.dtype != dtype or v.device != vt.device:
        raise ValueError("values must be values_t's transpose")
    prices, profits, p2o, o2p, eps, meta = kernel_state(states, dtype)
    check_bid_rows(bid_rows, b, vt.device)
    lib = _kernel_lib()
    with torch.cuda.device(vt.device):
        stream = torch.cuda.current_stream(vt.device).cuda_stream
        rc = lib.slap_fr_rounds(
            int(dtype == torch.int32), v.data_ptr(), vt.data_ptr(),
            prices.data_ptr(), profits.data_ptr(), p2o.data_ptr(),
            o2p.data_ptr(), eps.data_ptr(), meta.data_ptr(),
            bid_rows.data_ptr() if bid_rows is not None else None,
            phase_cycles.data_ptr() if phase_cycles is not None else None,
            stamps.data_ptr() if stamps is not None else None,
            log.data_ptr() if log is not None else None,
            b, n, int(rounds), stream,
        )
    if rc != 0:
        msg = lib.slap_cuda_error_string(rc).decode()
        raise RuntimeError(f"FR kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return state_from_kernel(states, prices, profits, p2o, o2p, meta)


def kernel_state(states: FRState, dtype):
    """The kernels' in-out buffers of a batched state: contiguous copies
    of prices, profits, p2o and o2p that a kernel updates in place (the
    inputs stay intact), eps, and the meta rows ``[B, 5]`` int32 (nits,
    forward_mode, done, since_inc, stall_k)."""
    prices = states.prices.to(dtype).contiguous().clone()
    profits = states.profits.to(dtype).contiguous().clone()
    p2o = states.p2o.to(torch.int32).contiguous().clone()
    o2p = states.o2p.to(torch.int32).contiguous().clone()
    eps = states.eps.to(dtype).contiguous()
    meta = torch.stack(
        [states.nits, states.forward_mode, states.done, states.since_inc,
         states.stall_k], dim=1,
    ).to(torch.int32).contiguous()
    return prices, profits, p2o, o2p, eps, meta


def state_from_kernel(states: FRState, prices, profits, p2o, o2p,
                      meta) -> FRState:
    """The state after a launch on :func:`kernel_state`'s buffers;
    ``eps`` and ``nreductions`` pass through, ``optimal_found |=
    done``."""
    done = meta[:, 2] != 0
    return FRState(
        prices=prices,
        profits=profits,
        p2o=p2o,
        o2p=o2p,
        eps=states.eps,
        forward_mode=meta[:, 1] != 0,
        since_inc=meta[:, 3].contiguous(),
        stall_k=meta[:, 4].contiguous(),
        nits=meta[:, 0].contiguous(),
        nreductions=states.nreductions,
        optimal_found=states.optimal_found | done,
        done=done,
    )


def check_bid_rows(bid_rows, b: int, device) -> None:
    """Raise unless ``bid_rows`` is None or a contiguous int64 ``[B]``
    tensor on ``device``."""
    if bid_rows is not None and (
        bid_rows.dtype != torch.int64 or tuple(bid_rows.shape) != (b,)
        or bid_rows.device != device or not bid_rows.is_contiguous()
    ):
        raise ValueError("bid_rows must be a contiguous int64 [B] tensor "
                         "on the values' device")
