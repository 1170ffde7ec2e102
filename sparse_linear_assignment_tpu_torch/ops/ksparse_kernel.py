"""Multi-round batched-sparse Khosla kernel (``csrc/ksp_kernel.cu``).

Replaces the JAX package's Pallas TPU kernel ``ops/pallas_ksparse.py:
_ksp_kernel``, driven there by ``ksp_rounds_pallas_flat`` and
``ksp_chunk_pallas``.  :func:`ksp_chunk` runs up to ``rounds`` rounds of
``ops/auction.py:khosla_round`` on every instance of a densified
person-major plane ``values_nm [B, N, M']`` (``-inf`` at non-arcs), each
instance leaving the loop as soon as it has no active person
(unassigned and not dropped).  ``o2p`` passes through unchanged: the
round only ever writes it, and the host rebuilds it from the final
``p2o``.

What bounds it on an H100.  The first round reads every person's row,
so the plane is read once (1 GiB at 4096 x 128 x 512 float32); later
rounds read only the rows of the persons still active, and the
arithmetic is a subtract and two compares per element.  The kernel is
bound by those bytes, which need many loads in flight on every SM, and,
after the last instances start, by the latency of their rounds with one
or two bidders.  The first port (one warp walking a row in 4-byte
loads, a dependent reload of the best value, three barriers and passes
over every person and object a round, 256 threads) kept about one
128-byte line in flight a warp.  The design against that:

- one CTA of 128 threads per instance, 8 resident on an SM (64
  registers a thread, no spills); prices,
  one 64-bit key per object, ``p2o``, ``dropped``, two active lists and
  the round's targets stay in shared memory for the whole loop (12
  bytes per object, 17 per person), so a round's only device-memory
  traffic is its active rows;
- one warp per active person issues the row's 16-byte loads, four a
  lane in flight (the whole 2 KB row at M' = 512) before it folds any,
  takes the top-2 with the smallest-index tie rule
  (``csrc/fr_common.cuh``) carrying the row's value at the best object
  through the merge (no second load), and posts its bid with one
  ``atomicMax`` on the object's key;
- between rounds a key rests at its object's owner, so the one bid that
  finds it at rest displaces the owner, and the apply pass walks only
  the round's entries: two barriers a round and no pass over all
  persons or objects; ``o2p`` is not read;
- the TPU kernel's lane-halving trees, coded won/displaced reduction,
  packed ``[8, M]`` and ``[8, 128]`` refs and plane resident on chip are
  not carried over: one 128 x 512 float32 instance is 256 KB, more than
  the 227 KB of shared memory a block can use, and rounds after the
  first touch few rows.

``phase_cycles`` splits the leader thread's cycles by phase; ``stamps``
gives each CTA's start and end, the waves and the straggler; with
tracing on (``SLAP_TPU_DEBUG``) or ``trace_rows`` given, each CTA's
thread 0 logs one row a round (``ops/round_log.py``).  Limits:
float32 values; ``M'`` a multiple of 4 (16-byte rows); ``12 M' + 17 N``
bytes of shared memory within ``MAX_SMEM_BYTES`` (an instance of 128
persons may have up to about 19,000 objects).  The staging code pads the
plane width to a multiple of ``PLANE_ALIGN`` values so that every row
starts on a 128-byte line.  ``p2o`` must be a matching (no object owned
twice), as every state of the rounds is.

On CPU tensors :func:`ksp_chunk` runs the plain PyTorch version
:func:`ksp_chunk_reference`; on CUDA tensors it launches the kernel or
raises.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..solution import UNASSIGNED
from ..utils.trace import is_enabled
from . import _build, round_log
from .auction import KhoslaState, khosla_round
from .dense import DenseProblem
from .fr_kernel import check_counters

#: kernel launches made by :func:`ksp_chunk` in this process
LAUNCHES = 0

#: shared memory one block can use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

#: the staged plane's width is padded to a multiple of this many values
#: (one warp, 128 bytes of float32): rows then start on a 128-byte line
#: and a warp's loads are whole lines.  Padding columns hold ``-inf``
#: and price 0 and are never bid, so any width at or above the used
#: one gives the same result.
PLANE_ALIGN = 32

#: the phase counters of ``phase_cycles``, in order: clock64 cycles of
#: each CTA's thread 0 summed over CTAs (``active`` listing the active
#: persons, once at entry; ``bids`` the row loads, top-2s, drops, bids
#: and displacements; ``apply`` the winners, prices and the next list;
#: ``prices`` a separate price and key pass, which this design does not
#: have (``tools/ksp_kernel_three_pass.cu``, the first port, charges all four
#: every round); ``barrier_wait`` the time in block barriers; ``total``
#: the entry pass and the rounds), and the rounds run
PHASES = ("active", "bids", "apply", "prices", "barrier_wait", "total",
          "rounds")

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``ksp_kernel`` library (also
    used for the variant builds of ``tools/ksp_kernel_variants.py``)."""
    p = ctypes.c_void_p
    lib.slap_ksp_rounds.argtypes = [
        p, p, p, p, p, p, p, p, p, p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
    ]
    lib.slap_ksp_rounds.restype = ctypes.c_int
    lib.slap_ksp_error_string.argtypes = [ctypes.c_int]
    lib.slap_ksp_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(_build.load("ksp_kernel"))
    return _lib


def smem_bytes(n: int, m: int) -> int:
    """Shared memory the kernel needs for one ``n x m`` instance."""
    return 12 * m + 17 * n


def khosla_init(values_nm: torch.Tensor) -> KhoslaState:
    """Initial batched state of a person-major plane ``[B, N, M']``:
    zero prices, nobody assigned or dropped."""
    b, n, m = values_nm.shape
    dev = values_nm.device
    return KhoslaState(
        prices=torch.zeros((b, m), dtype=values_nm.dtype, device=dev),
        p2o=torch.full((b, n), UNASSIGNED, dtype=torch.int32, device=dev),
        o2p=torch.full((b, m), UNASSIGNED, dtype=torch.int32, device=dev),
        dropped=torch.zeros((b, n), dtype=torch.bool, device=dev),
        nits=torch.zeros(b, dtype=torch.int32, device=dev),
    )


def check_state(values_nm: torch.Tensor, states: KhoslaState,
                thresholds: torch.Tensor) -> None:
    """Raise unless ``values_nm`` is a ``[B, N, M']`` float plane and
    ``states`` and ``thresholds`` are batched of its shape and device."""
    if values_nm.dim() != 3:
        raise ValueError("values_nm must be [B, N, M']")
    if not values_nm.dtype.is_floating_point:
        raise ValueError(f"ksp_chunk takes float values, got "
                         f"{values_nm.dtype}")
    b, n, m = values_nm.shape
    for name, t, want in (
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
        if t.device != values_nm.device:
            raise ValueError(f"{name} is on {t.device}, values_nm on "
                             f"{values_nm.device}")


def _check_act_rows(act_rows, b: int, device) -> None:
    if act_rows is not None and (
        act_rows.dtype != torch.int64 or tuple(act_rows.shape) != (b,)
        or act_rows.device != device or not act_rows.is_contiguous()
    ):
        raise ValueError("act_rows must be a contiguous int64 [B] tensor "
                         "on the values' device")


def ksp_chunk_reference(values_nm, states: KhoslaState, eps, thresholds,
                        rounds: int, act_rows=None,
                        trace_rows=None) -> KhoslaState:
    """Plain PyTorch version of the kernel: a loop of
    :func:`~.auction.khosla_round` on the transposed view of the plane,
    stopped once no instance has an active person.  A round leaves an
    instance without active persons unchanged, which is the kernel's
    per-instance early exit.  Any float dtype.  ``act_rows [B]`` int64,
    if given, gains the number of active persons' rows each instance
    read; ``trace_rows`` receives the kernel's round trace
    (:func:`ksp_chunk`)."""
    check_state(values_nm, states, thresholds)
    b = values_nm.shape[0]
    width = len(round_log.KSP_FIELDS)
    _check_act_rows(act_rows, b, values_nm.device)
    round_log.check_rows(trace_rows, b, rounds, width, values_nm.device)
    log = trace_rows is not None or is_enabled()
    rows = []
    problem = DenseProblem(values_nm.transpose(1, 2))
    s = states
    for _ in range(rounds):
        active = (s.p2o == UNASSIGNED) & ~s.dropped
        if not bool(active.any()):
            break
        if act_rows is not None:
            act_rows += active.sum(dim=1)
        s = khosla_round(problem, s, eps, thresholds, trace=False)
        if log:
            left = ((s.p2o == UNASSIGNED) & ~s.dropped).any(dim=1)
            row = torch.stack([s.nits, left, ~left], dim=1).to(torch.int32)
            rows.append(torch.where(active.any(dim=1)[:, None], row, 0))
    if log:
        round_log.plain_rows(rows, trace_rows, round_log.KSP_FORMAT,
                             s.nits - states.nits, b, width,
                             values_nm.device)
    return s._replace(o2p=states.o2p)


def ksp_chunk(values_nm, states: KhoslaState, eps, thresholds,
              rounds: int, act_rows=None, phase_cycles=None,
              stamps=None, trace_rows=None) -> KhoslaState:
    """Up to ``rounds`` fused Khosla rounds over a batched
    :class:`KhoslaState` on the densified person-major plane
    ``values_nm [B, N, M']`` (float32).  ``eps`` is a scalar,
    ``thresholds [B]`` the drop thresholds.  Every person needs at least
    one arc (a finite value): the staging functions check it.  CPU
    tensors run :func:`ksp_chunk_reference`; CUDA tensors launch the
    kernel.

    Round trace: with tracing on, each instance's rounds are printed
    after the launch, one line a round in JAX's format
    (``round_log.KSP_FORMAT``); ``trace_rows``, a contiguous int32
    ``[B, rounds, 3]`` tensor on the values' device, receives the rows
    (``round_log.KSP_FIELDS`` after each round run, zero after the
    instance stopped), on either device.

    Measurement (CUDA tensors only: the plain version has no clock):
    ``phase_cycles``, a contiguous int64 tensor of ``len(PHASES)``,
    gains the kernel's phase counters; ``stamps``, a contiguous int64
    ``[B, 2]`` tensor, receives each CTA's start and end on the card's
    global timer (nanoseconds)."""
    check_state(values_nm, states, thresholds)
    check_counters(values_nm, len(PHASES), phase_cycles, stamps)
    b = values_nm.shape[0]
    round_log.check_rows(trace_rows, b, rounds, len(round_log.KSP_FIELDS),
                         values_nm.device)
    if values_nm.device.type == "cpu":
        return ksp_chunk_reference(values_nm, states, eps, thresholds,
                                   rounds, act_rows, trace_rows)
    if values_nm.device.type != "cuda":
        raise ValueError(f"ksp_chunk runs on cpu or cuda, not "
                         f"{values_nm.device}")
    return round_log.launch_traced(
        lambda s, r, log: _ksp_chunk_cuda(values_nm, s, eps, thresholds, r,
                                          act_rows, phase_cycles, stamps,
                                          log),
        states, rounds, trace_rows, round_log.KSP_FORMAT, b,
        len(round_log.KSP_FIELDS), values_nm.device, lambda s: s.nits,
    )


def _ksp_chunk_cuda(values_nm, states, eps, thresholds, rounds, act_rows,
                    phase_cycles, stamps, log):
    global LAUNCHES
    b, n, m = values_nm.shape
    if values_nm.dtype != torch.float32:
        raise ValueError(f"the Khosla kernel takes float32 values, got "
                         f"{values_nm.dtype}; other types run "
                         f"ksp_chunk_reference")
    need = smem_bytes(n, m)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {n}x{m} instance needs {need} bytes of shared memory "
            f"(12 per object, 17 per person), more than the "
            f"{MAX_SMEM_BYTES} a block can use"
        )
    _check_act_rows(act_rows, b, values_nm.device)
    vals = values_nm.contiguous()
    if m % 4 or vals.data_ptr() % 16:
        raise ValueError(f"the Khosla kernel reads rows in 16-byte loads: "
                         f"the plane width ({m}) must be a multiple of 4 "
                         f"and the plane 16-byte aligned (the staging "
                         f"functions pad it to a multiple of "
                         f"{PLANE_ALIGN})")
    prices = states.prices.to(torch.float32).contiguous().clone()
    p2o = states.p2o.to(torch.int32).contiguous().clone()
    dropped = states.dropped.to(torch.bool).contiguous().clone()
    nits = states.nits.to(torch.int32).contiguous().clone()
    thr = thresholds.to(torch.float32).contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.slap_ksp_rounds(
            vals.data_ptr(), prices.data_ptr(), p2o.data_ptr(),
            dropped.data_ptr(), nits.data_ptr(), thr.data_ptr(),
            act_rows.data_ptr() if act_rows is not None else None,
            phase_cycles.data_ptr() if phase_cycles is not None else None,
            stamps.data_ptr() if stamps is not None else None,
            log.data_ptr() if log is not None else None,
            float(eps), b, n, m, int(rounds), stream,
        )
    if rc != 0:
        msg = lib.slap_ksp_error_string(rc).decode()
        raise RuntimeError(f"Khosla kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return KhoslaState(prices=prices, p2o=p2o, o2p=states.o2p,
                       dropped=dropped, nits=nits)
