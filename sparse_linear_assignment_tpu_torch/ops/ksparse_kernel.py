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
bound by those bytes and, in its last rounds, by the latency of a round
with one or two bidders.  The design against that:

- one CTA of 256 threads per instance; prices, one 64-bit conflict key
  per object, ``p2o``, ``dropped`` and the round's choices stay in
  shared memory for the whole loop (12 bytes per object, 13 per
  person), so a round's only device-memory traffic is its active rows;
- one warp per active person reads that person's row, coalesced, takes
  the top-2 with the smallest-index tie rule (``csrc/fr_common.cuh``)
  and posts its bid with one ``atomicMax`` on the object's key; a
  displaced owner is found by a plain indexed read of its object's key;
- the TPU kernel's lane-halving trees, coded won/displaced reduction,
  packed ``[8, M]`` and ``[8, 128]`` refs and plane resident on chip are
  not carried over: one 128 x 512 float32 instance is 256 KB, more than
  the 227 KB of shared memory a block can use, and rounds after the
  first touch few rows;
- several instances per SM hide one instance's round latency.

Limits: float32 values; ``12 M' + 13 N`` bytes of shared memory within
``MAX_SMEM_BYTES`` (an instance of 128 persons may have up to about
19,000 objects).  The plane width ``M'`` is free; the staging code pads
it to a multiple of ``PLANE_ALIGN`` values so that every row starts on a
128-byte line.

On CPU tensors :func:`ksp_chunk` runs the plain PyTorch version
:func:`ksp_chunk_reference`; on CUDA tensors it launches the kernel or
raises.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..solution import UNASSIGNED
from . import _build
from .auction import KhoslaState, khosla_round
from .dense import DenseProblem

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

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ksp_kernel")
        p = ctypes.c_void_p
        lib.slap_ksp_rounds.argtypes = [
            p, p, p, p, p, p, p, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
        ]
        lib.slap_ksp_rounds.restype = ctypes.c_int
        lib.slap_ksp_error_string.argtypes = [ctypes.c_int]
        lib.slap_ksp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(n: int, m: int) -> int:
    """Shared memory the kernel needs for one ``n x m`` instance."""
    return 12 * m + 13 * n


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
                        rounds: int, act_rows=None) -> KhoslaState:
    """Plain PyTorch version of the kernel: a loop of
    :func:`~.auction.khosla_round` on the transposed view of the plane,
    stopped once no instance has an active person.  A round leaves an
    instance without active persons unchanged, which is the kernel's
    per-instance early exit.  Any float dtype.  ``act_rows [B]`` int64,
    if given, gains the number of active persons' rows each instance
    read."""
    check_state(values_nm, states, thresholds)
    _check_act_rows(act_rows, values_nm.shape[0], values_nm.device)
    problem = DenseProblem(values_nm.transpose(1, 2))
    s = states
    for _ in range(rounds):
        active = (s.p2o == UNASSIGNED) & ~s.dropped
        if not bool(active.any()):
            break
        if act_rows is not None:
            act_rows += active.sum(dim=1)
        s = khosla_round(problem, s, eps, thresholds)
    return s._replace(o2p=states.o2p)


def ksp_chunk(values_nm, states: KhoslaState, eps, thresholds,
              rounds: int, act_rows=None) -> KhoslaState:
    """Up to ``rounds`` fused Khosla rounds over a batched
    :class:`KhoslaState` on the densified person-major plane
    ``values_nm [B, N, M']`` (float32).  ``eps`` is a scalar,
    ``thresholds [B]`` the drop thresholds.  Every person needs at least
    one arc (a finite value): the staging functions check it.  CPU
    tensors run :func:`ksp_chunk_reference`; CUDA tensors launch the
    kernel."""
    if values_nm.device.type == "cpu":
        return ksp_chunk_reference(values_nm, states, eps, thresholds,
                                   rounds, act_rows)
    check_state(values_nm, states, thresholds)
    if values_nm.device.type != "cuda":
        raise ValueError(f"ksp_chunk runs on cpu or cuda, not "
                         f"{values_nm.device}")
    return _ksp_chunk_cuda(values_nm, states, eps, thresholds, rounds,
                           act_rows)


def _ksp_chunk_cuda(values_nm, states, eps, thresholds, rounds, act_rows):
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
            f"(12 per object, 13 per person), more than the "
            f"{MAX_SMEM_BYTES} a block can use"
        )
    _check_act_rows(act_rows, b, values_nm.device)
    vals = values_nm.contiguous()
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
            float(eps), b, n, m, int(rounds), stream,
        )
    if rc != 0:
        msg = lib.slap_ksp_error_string(rc).decode()
        raise RuntimeError(f"Khosla kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return KhoslaState(prices=prices, p2o=p2o, o2p=states.o2p,
                       dropped=dropped, nits=nits)
