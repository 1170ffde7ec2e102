"""Forward-reverse auction rounds of one big dense instance on one
thread-block cluster (``csrc/fr_big_kernel.cu``).

Replaces the JAX package's Pallas TPU kernel ``ops/pallas_fr_big.py:
_fr_big_kernel``, driven there by ``fr_big_chunk``.  :func:`fr_big_chunk`
runs up to ``rounds`` rounds of ``ops/fr_dense.py:fr_round(
skip_certificate=True)`` on one instance, stopping as soon as its
matching is full.  The state is a batch-1 :class:`FRState`, so
``fr_init``, ``fr_round`` and ``weights_from_jax_state`` serve it as
they serve the batched path.

The TPU kernel streams the whole matrix through VMEM every round, and
most of its machinery exists for that: the block height, the packed
``[G, BM]`` state, the diagonal transposes, the dirty-block top-2 caches
and the double-buffered DMA.  None of it carries over: on the card only
the current bidders' rows are read.

What bounds it on an H100.  After a few wide opening rounds a round has
a handful of bidders (about 8 on average at 4096²), so its bytes are
tiny (every bidder row of a 4096² solve together takes 0.21 ms at
3.35 TB/s) and the kernel is bound by latency: rounds × (barriers + one
dependent row load).  The previous design, a cooperative launch over
every SM with three grid barriers a round, one warp walking each 16 KB
row in 128 dependent steps and the state in global memory, took 17.3 µs
a round.  The design against that latency:

- one cluster of up to 16 CTAs holds the whole solve, with the round
  loop inside; a hardware cluster barrier replaces the grid barrier,
  four a round;
- the state lives in the cluster's distributed shared memory, each CTA
  owning one slice of ``S / C`` indices on both sides, loaded from the
  state tensors at entry and written back at exit;
- each bidder's row is split by the same slices: a CTA reads only its
  segment and subtracts its own local prices, several bidders a warp
  step with every load in flight, so a round costs about one load
  latency; the partial top-2s merge exactly with 32-bit atomics on the
  bidder owner's shared memory;
- the rest of a round is one pass over each CTA's own slice.

:func:`plan` sizes the launch (cluster size, slice width, bidders a
warp step, partials a pass, shared-memory bytes) and raises when an
instance does not fit.  With tracing on (``SLAP_TPU_DEBUG``) or
``trace_rows`` given, the cluster's leader thread logs one row a round
(``ops/round_log.py``).  On CPU tensors :func:`fr_big_chunk` runs the
plain PyTorch version :func:`fr_big_chunk_reference`; on CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build, round_log
from .fr_dense import FRState
from .fr_kernel import (
    check_bid_rows,
    check_state,
    kernel_state,
    plain_chunk,
    state_from_kernel,
)

#: kernel launches made by :func:`fr_big_chunk` in this process
LAUNCHES = 0

#: shared memory one block can use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

#: the largest thread-block cluster Hopper places (a non-portable size;
#: 8 is the portable one)
MAX_CLUSTER = 16

#: shared-memory bytes a CTA keeps per index of its slice: the conflict
#: key (8), the four merge words (4 x 4), prices, profits, p2o, o2p,
#: argbest and floor (6 x 4), the two bidder lists (2 x 4)
STATE_BYTES_PER_INDEX = 56

#: bytes of one bidder's partial top-2 (best, second, argbest, bidder)
PARTIAL_BYTES = 16

#: the kernel's static shared memory (control words), kept free
STATIC_SMEM_BYTES = 1024

#: fewest bidder rows one pass of partials must hold (fewer would split
#: the opening rounds into many passes)
MIN_PASS_ROWS = 1024

#: float4 loads a lane keeps in flight in the row walk (the kernel's
#: kLoadsInFlight)
LOADS_IN_FLIGHT = 8

#: the phase counters of ``phase_cycles``, in order: leader-thread
#: clock64 cycles summed over rounds
PHASES = ("rows", "merge_bid", "apply", "control", "barrier_wait",
          "total", "wide_rounds", "wide_cycles", "barriers")

_lib = None


class Plan(NamedTuple):
    cluster: int        # CTAs of the cluster
    width: int          # indices each CTA owns on each side, S / cluster
    rows_per_step: int  # bidders a warp walks at once
    pass_rows: int      # bidders whose partials one pass holds
    smem_bytes: int     # dynamic shared memory of a CTA


def plan(S: int, smem_per_block: Optional[int] = None,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """The launch shape of an ``S x S`` instance.  The cluster is 16
    CTAs where ``max_cluster`` allows it, else 8; a warp walks as many
    bidders at once as keep ``LOADS_IN_FLIGHT`` float4 loads a lane in
    flight; the partials take what shared memory the state leaves, up to
    one per row.  Raises ``ValueError`` naming the limit when ``S`` does
    not fit.  ``smem_per_block`` defaults to ``MAX_SMEM_BYTES``."""
    if smem_per_block is None:
        smem_per_block = MAX_SMEM_BYTES
    if max_cluster >= 16:
        c = 16
    elif max_cluster >= 8:
        c = 8
    else:
        raise ValueError(f"the big FR kernel needs a cluster of at least "
                         f"8 CTAs, the card allows {max_cluster}")
    if S <= 0 or S % (4 * c):
        raise ValueError(f"the big FR kernel splits the side over {c} "
                         f"CTAs in float4 slices: S must be a positive "
                         f"multiple of {4 * c}, got {S}")
    w = S // c
    state = STATE_BYTES_PER_INDEX * w
    avail = smem_per_block - STATIC_SMEM_BYTES - state
    pass_rows = min(S, max(avail, 0) // PARTIAL_BYTES)
    if pass_rows < min(S, MIN_PASS_ROWS):
        largest = ((smem_per_block - STATIC_SMEM_BYTES
                    - PARTIAL_BYTES * MIN_PASS_ROWS)
                   // STATE_BYTES_PER_INDEX) * c // (4 * c) * (4 * c)
        raise ValueError(
            f"a {S}² instance needs {state} bytes of state a CTA plus "
            f"{PARTIAL_BYTES * min(S, MIN_PASS_ROWS)} of partials, over "
            f"the {smem_per_block}-byte shared-memory limit of a block "
            f"at a cluster of {c}: the largest side is {largest}")
    loads = -(-w // 128)  # float4 loads a lane per row segment
    rows = LOADS_IN_FLIGHT
    while rows > 1 and rows * loads > LOADS_IN_FLIGHT:
        rows //= 2
    return Plan(c, w, rows, pass_rows, state + PARTIAL_BYTES * pass_rows)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fr_big_kernel")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.slap_fr_big_rounds.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p,
        ]
        lib.slap_fr_big_rounds.restype = ctypes.c_int
        lib.slap_fr_big_probe.argtypes = [p, i, i, p, p]
        lib.slap_fr_big_probe.restype = ctypes.c_int
        lib.slap_cuda_error_string.argtypes = [ctypes.c_int]
        lib.slap_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fr_big_chunk_reference(values_t, state: FRState, rounds: int,
                           bid_rows=None, trace_rows=None):
    """Plain PyTorch version of the kernel: ``fr_round(skip_certificate=
    True)`` in a loop with the kernel's early exit (the plain version of
    the batched kernel, at batch 1).  ``bid_rows [1]`` int64, if given,
    gains the number of bidder rows read; ``trace_rows`` receives the
    kernel's round trace (:func:`fr_big_chunk`)."""
    return plain_chunk(values_t, state, rounds, bid_rows, trace_rows,
                       round_log.FR_BIG_FORMAT)


def fr_big_chunk(values_t, state: FRState, rounds: int, values=None,
                 bid_rows=None, phase_cycles=None, trace_rows=None):
    """Up to ``rounds`` rounds of one instance; returns ``(state,
    done)``.

    ``values_t [1, M, N]`` float32 with M == N; ``values`` is its
    transpose ``[1, N, M]`` if the caller already has it (built here
    otherwise).  ``state`` is a batch-1 :class:`FRState`; ``eps`` and
    ``nreductions`` pass through, ``optimal_found |= done``.  CPU
    tensors run :func:`fr_big_chunk_reference`; CUDA tensors launch the
    kernel.  ``phase_cycles``, a contiguous int64 tensor of
    ``len(PHASES)`` on the card, gains the kernel's phase counters
    (CUDA tensors only: the plain version has no cycles).

    Round trace: with tracing on, the rounds are printed after the
    launch, one line a round in JAX's format
    (``round_log.FR_BIG_FORMAT``); ``trace_rows``, a contiguous int32
    ``[1, rounds, 4]`` tensor on the values' device, receives the rows
    (``round_log.FR_FIELDS``), on either device."""
    check_state(values_t, state)
    if values_t.shape[0] != 1:
        raise ValueError(f"fr_big_chunk solves one instance, got a batch "
                         f"of {values_t.shape[0]}")
    if values_t.dtype != torch.float32:
        raise ValueError(f"fr_big_chunk takes float32 values, got "
                         f"{values_t.dtype}")
    round_log.check_rows(trace_rows, 1, rounds, len(round_log.FR_FIELDS),
                         values_t.device)
    if values_t.device.type == "cpu":
        if phase_cycles is not None:
            raise ValueError("phase_cycles counts the CUDA kernel's clock "
                             "cycles; the plain version has none")
        return fr_big_chunk_reference(values_t, state, rounds, bid_rows,
                                      trace_rows)
    if values_t.device.type != "cuda":
        raise ValueError(f"fr_big_chunk runs on cpu or cuda, not "
                         f"{values_t.device}")
    new = round_log.launch_traced(
        lambda s, r, log: _fr_big_chunk_cuda(values_t, s, r, values,
                                             bid_rows, phase_cycles, log),
        state, rounds, trace_rows, round_log.FR_BIG_FORMAT, 1,
        len(round_log.FR_FIELDS), values_t.device, lambda s: s.nits,
    )
    return new, new.done.all()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernel_lib().slap_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _fr_big_chunk_cuda(values_t, state, rounds, values, bid_rows,
                       phase_cycles, log):
    global LAUNCHES
    n = values_t.shape[2]
    pl = plan(n)
    vt = values_t.contiguous()
    v = (vt.transpose(1, 2) if values is None else values).contiguous()
    if v.shape != vt.shape or v.dtype != vt.dtype or v.device != vt.device:
        raise ValueError("values must be values_t's transpose")
    prices, profits, p2o, o2p, eps, meta = kernel_state(state, vt.dtype)
    check_bid_rows(bid_rows, 1, vt.device)
    if phase_cycles is not None and (
        phase_cycles.dtype != torch.int64
        or tuple(phase_cycles.shape) != (len(PHASES),)
        or phase_cycles.device != vt.device
        or not phase_cycles.is_contiguous()
    ):
        raise ValueError(f"phase_cycles must be a contiguous int64 "
                         f"[{len(PHASES)}] tensor on the values' device")
    lib = _kernel_lib()
    with torch.cuda.device(vt.device):
        stream = torch.cuda.current_stream(vt.device).cuda_stream
        rc = lib.slap_fr_big_rounds(
            v.data_ptr(), vt.data_ptr(), prices.data_ptr(),
            profits.data_ptr(), p2o.data_ptr(), o2p.data_ptr(),
            eps.data_ptr(), meta.data_ptr(),
            bid_rows.data_ptr() if bid_rows is not None else None,
            phase_cycles.data_ptr() if phase_cycles is not None else None,
            log.data_ptr() if log is not None else None,
            n, pl.cluster, pl.width, pl.rows_per_step, pl.pass_rows,
            pl.smem_bytes, int(rounds), stream,
        )
    _raise_on(rc, "big FR kernel")
    LAUNCHES += 1
    return state_from_kernel(state, prices, profits, p2o, o2p, meta)


def probe(chain: torch.Tensor, iters: int, cluster: int = MAX_CLUSTER):
    """The cost of a round's pieces on the card: nanoseconds of one
    cluster barrier (``cluster`` CTAs of the kernel's width) and of one
    dependent load along ``chain`` (int32 next indices on the card, each
    step a miss in L2), each averaged over ``iters``; and whether a
    64-bit max across the cluster's shared memory is atomic through
    ``atomicMax`` (it is not on the H100) and through the kernel's CAS
    loop."""
    if chain.dtype != torch.int32 or chain.device.type != "cuda":
        raise ValueError("chain must be an int32 tensor on the card")
    if not chain.is_contiguous():
        raise ValueError("chain must be contiguous")
    out = torch.zeros(5, dtype=torch.int64, device=chain.device)
    lib = _kernel_lib()
    with torch.cuda.device(chain.device):
        stream = torch.cuda.current_stream(chain.device).cuda_stream
        rc = lib.slap_fr_big_probe(chain.data_ptr(), int(iters),
                                   int(cluster), out.data_ptr(), stream)
    _raise_on(rc, "big FR probe")
    barrier_ns, load_ns, by_max, by_cas, _ = out.tolist()
    return {"cluster_barrier_ns": barrier_ns / iters,
            "hbm_load_ns": load_ns / iters,
            "dsmem_atomicmax64_atomic": bool(by_max),
            "dsmem_cas_max64_atomic": bool(by_cas)}
