"""One forward-auction round of a single dense instance on the card
(``csrc/dense_round_single.cu``), with the eps-CS margins of the updated
state.

Replaces the JAX package's Pallas TPU kernel
``ops/pallas_dense.py:_round_kernel`` (the ``pallas_call`` of
``fused_dense_round``), whose body is ``_round_math``.
:func:`fused_dense_round` keeps JAX's signature and returns what
:func:`~.dense_round.fused_dense_round_batch_reference` returns at
``B = 1``, bit for bit.  The batch entry point
(``dense_round.fused_dense_round_batch``) stays on the chunk kernel at
any ``B``.

What bounds it on an H100.  The plane read once, a subtract and two
compares an element: the bytes (the kernel reads the bidders' columns
for the bids and the plane again for the margins).  At 256² one read is
0.08 us at 3.35 TB/s, so small instances are bound by latency: one
launch, two dependent walks of an object slice and two grid barriers.
The design (the kernel's header has the details): the object-major
plane read as it arrives, a warp on 32 adjacent persons with one
coalesced line an object row; the objects cut into slices so that the
grid fills the card (:func:`plan`); the slices' partial top-2s merged
exactly, bids resolved by a 64-bit ``atomicMax`` on each object's key;
the state in global memory, so no shape limit beyond the card's memory;
eps and done passed by value, or by pointer when they are tensors on
the card, so a call copies nothing to the card.

On CPU tensors :func:`fused_dense_round` runs the plain version; on
CUDA tensors it launches the kernel or raises.  ``LAUNCHES`` counts the
rounds launched.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from . import _build
from .dense_round import fused_dense_round_batch_reference

#: rounds launched by :func:`fused_dense_round` in this process
LAUNCHES = 0

#: threads a CTA (8 warps) and rows a lane keeps in flight in a walk
THREADS = 256
WARPS = THREADS // 32
UNROLL = 8
#: work items (32-person tile x object slice) the planner aims for, so
#: that a small instance still spreads over most of the card's 132 SMs
TARGET_ITEMS = 128
#: the widest object slice: one item's walk is at most 512 rows, 8 steps
#: of 8 rows a warp
MAX_SLICE = 512

_lib = None
#: the kernel's pointer table: 14 device addresses
_PTRS = struct.Struct("<14Q")


class Plan(NamedTuple):
    """The launch of one ``M x N`` round: ``tiles`` 32-person tiles,
    ``slices`` object slices of ``width`` objects (the last may be
    shorter), ``items = tiles * slices`` work items a walk; the scratch
    buffer's size and the byte offsets of its arrays (partial top-2s
    ``[N, S]`` of 16 bytes, conflict keys ``[M]``, choices ``[N]``);
    ``walk_steps``, the dependent load steps of one warp's walk of a
    slice."""

    tiles: int
    width: int
    slices: int
    items: int
    scratch_bytes: int
    offsets: tuple
    walk_steps: int


@functools.lru_cache(maxsize=64)
def plan(m: int, n: int) -> Plan:
    """The launch of one round of ``m`` objects x ``n`` persons: slices
    of at least 8 objects (one row a warp) and at most ``MAX_SLICE``,
    as narrow as gives ``TARGET_ITEMS`` items."""
    if m <= 0 or n <= 0:
        raise ValueError(f"an empty instance ({m} objects x {n} persons)")
    tiles = -(-n // 32)
    width = -(-m * tiles // TARGET_ITEMS)
    width = min(MAX_SLICE, max(WARPS, -(-width // WARPS) * WARPS))
    slices = -(-m // width)
    sizes = (16 * n * slices, 8 * m, 4 * n)
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += -(-size // 16) * 16
    return Plan(tiles=tiles, width=width, slices=slices,
                items=tiles * slices, scratch_bytes=at,
                offsets=tuple(offsets),
                walk_steps=-(-width // (WARPS * UNROLL)))


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("dense_round_single")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.slap_dense_round_single.argtypes = [
            ctypes.c_char_p, ctypes.c_float, i, i, i, i, i, i, i, p,
        ]
        lib.slap_dense_round_single.restype = ctypes.c_int
        lib.slap_dense_round_single_error_string.argtypes = [ctypes.c_int]
        lib.slap_dense_round_single_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fused_dense_round_reference(vals_t, prices, p2o, o2p, eps, done):
    """Plain PyTorch version: the batch's plain round at ``B = 1``."""
    dev = vals_t.device
    out = fused_dense_round_batch_reference(
        vals_t[None], prices[None], p2o[None], o2p[None],
        torch.as_tensor(eps, dtype=vals_t.dtype, device=dev).reshape(1),
        torch.as_tensor(done, dtype=torch.bool, device=dev).reshape(1),
    )
    return tuple(x[0] for x in out)


def _dense(t, dtype):
    return t if t.dtype == dtype and t.is_contiguous() else (
        t.to(dtype).contiguous())


def _scalar_arg(x, dev, name, dtype):
    """``(value, tensor)``: a Python number, a numpy scalar or a CPU
    tensor is passed by value; a one-element tensor on the card by
    pointer (converted to ``dtype`` if it has another)."""
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        return x, None
    if x.numel() != 1:
        raise ValueError(f"{name} must be a scalar, got shape "
                         f"{tuple(x.shape)}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, vals_t on {dev}")
    return None, x if x.dtype == dtype else x.to(dtype)


def fused_dense_round(vals_t, prices, p2o, o2p, eps, done):
    """One fused forward-auction round of a single dense instance, the
    JAX package's ``fused_dense_round``: ``vals_t [M, N]`` (object-major,
    ``-inf`` at non-arcs), ``prices [M]``, ``p2o [N]`` int32, ``o2p
    [M]`` int32, ``eps`` a scalar (a number or a 0-d tensor), ``done`` a
    bool (or a 0-d tensor).  Only unassigned persons bid, and only while
    not ``done``.  Returns ``(prices', p2o', o2p', chosen_profit,
    max_profit)``, the last two the eps-CS margins of the updated state
    for every person.  CPU tensors run :func:`fused_dense_round_reference`;
    CUDA tensors launch the kernel (float32 values; the outputs are views
    of one allocation that also holds the kernel's scratch)."""
    dev = vals_t.device
    if dev.type == "cpu":
        return fused_dense_round_reference(vals_t, prices, p2o, o2p, eps,
                                           done)
    if dev.type != "cuda":
        raise ValueError(f"the dense round runs on cpu or cuda, not {dev}")
    if vals_t.dim() != 2:
        raise ValueError("vals_t must be [M, N]")
    if vals_t.dtype != torch.float32:
        raise ValueError(f"the single dense round kernel takes float32 "
                         f"values, got {vals_t.dtype}")
    m, n = vals_t.shape
    for name, t, want in (("prices", prices, (m,)), ("p2o", p2o, (n,)),
                          ("o2p", o2p, (m,))):
        if t.shape != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vals_t on {dev}")
    eps_val, eps_t = _scalar_arg(eps, dev, "eps", torch.float32)
    done_val, done_t = _scalar_arg(done, dev, "done", torch.bool)
    pl = plan(m, n)
    # one allocation: the scratch, then prices', o2p', p2o', chosen, maxp
    words = pl.scratch_bytes // 4
    buf = torch.empty(words + 2 * m + 3 * n, dtype=torch.float32,
                      device=dev)
    _, prices_out, o2p_out, p2o_out, chosen, maxp = buf.split_with_sizes(
        (words, m, m, n, n, n))
    base = buf.data_ptr()
    at = base + 4 * words
    _launch(_dense(vals_t, torch.float32), _dense(prices, torch.float32),
            _dense(p2o, torch.int32), _dense(o2p, torch.int32),
            0.0 if eps_t is not None else float(eps_val), eps_t,
            0 if done_t is not None else int(bool(done_val)), done_t,
            (at, at + 8 * m, at + 4 * m, at + 8 * m + 4 * n,
             at + 8 * m + 8 * n), base, pl)
    return (prices_out, p2o_out.view(torch.int32), o2p_out.view(torch.int32),
            chosen, maxp)


def _launch(vals, prices, p2o, o2p, eps, eps_t, done, done_t, outs,
            scratch, pl: Plan, phases=7):
    """Launch one round: ``eps``/``done`` by value unless ``eps_t``/
    ``done_t`` (float32 and bool tensors on the card) are given; ``outs``
    the device addresses of prices', p2o', o2p', chosen and maxp;
    ``scratch`` the address of ``pl.scratch_bytes`` bytes, 16-byte
    aligned.  ``phases`` picks the kernel instance: 7 the round; 0 (the
    launch and barriers alone), 1 and 3 (bit k: phase k + 1) only to
    time the pieces."""
    global LAUNCHES
    index = vals.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(vals, prices, p2o, o2p, eps, eps_t, done, done_t,
                           outs, scratch, pl, phases)
    ptrs = _PTRS.pack(
        vals.data_ptr(), prices.data_ptr(), p2o.data_ptr(), o2p.data_ptr(),
        0 if eps_t is None else eps_t.data_ptr(),
        0 if done_t is None else done_t.data_ptr(), *outs,
        *(scratch + off for off in pl.offsets))
    m, n = vals.shape
    lib = _kernel_lib()
    # the current stream's handle; torch.cuda.current_stream() gives the
    # same through a Stream object, at several microseconds a call
    stream = torch._C._cuda_getCurrentRawStream(index)
    rc = lib.slap_dense_round_single(
        ptrs, eps, done, m, n, pl.width, pl.slices, pl.tiles, phases,
        stream)
    if rc != 0:
        msg = lib.slap_dense_round_single_error_string(rc).decode()
        raise RuntimeError(f"single dense round kernel launch failed: "
                           f"{msg} ({rc})")
    LAUNCHES += 1
