"""Forward-reverse auction rounds of one big dense instance, spread over
the whole card (``csrc/fr_big_kernel.cu``).

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

What bounds it on an H100.  One instance beyond 1024² does not fit in
one SM's shared memory, and one SM would leave 131 idle, so the kernel
is a persistent cooperative launch over every SM, with the round loop
inside and grid barriers between a round's phases.  Early rounds read
thousands of bidder rows and are bound by those bytes; the long endgame
has a handful of bidders per round and is bound by latency: three grid
barriers and a dependent chain of row loads and atomics per round.  The
design keeps the state (a few hundred KB at 8192²) in L2 and reads only
bidders' rows, in whichever layout makes them contiguous.

On CPU tensors :func:`fr_big_chunk` runs the plain PyTorch version
:func:`fr_big_chunk_reference`; on CUDA tensors it launches the kernel
or raises.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fr_dense import FRState
from .fr_kernel import (
    check_bid_rows,
    check_state,
    fr_chunk_reference,
    kernel_state,
    state_from_kernel,
)

#: kernel launches made by :func:`fr_big_chunk` in this process
LAUNCHES = 0

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fr_big_kernel")
        p = ctypes.c_void_p
        lib.slap_fr_big_rounds.argtypes = [
            p, p, p, p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, p,
        ]
        lib.slap_fr_big_rounds.restype = ctypes.c_int
        lib.slap_fr_big_scratch_words.argtypes = [ctypes.c_int]
        lib.slap_fr_big_scratch_words.restype = ctypes.c_longlong
        lib.slap_cuda_error_string.argtypes = [ctypes.c_int]
        lib.slap_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fr_big_chunk_reference(values_t, state: FRState, rounds: int,
                           bid_rows=None):
    """Plain PyTorch version of the kernel: ``fr_round(skip_certificate=
    True)`` in a loop with the kernel's early exit (the plain version of
    the batched kernel, at batch 1).  ``bid_rows [1]`` int64, if given,
    gains the number of bidder rows read."""
    return fr_chunk_reference(values_t, state, rounds, bid_rows)


def fr_big_chunk(values_t, state: FRState, rounds: int, values=None,
                 bid_rows=None):
    """Up to ``rounds`` rounds of one instance; returns ``(state,
    done)``.

    ``values_t [1, M, N]`` float32 with M == N; ``values`` is its
    transpose ``[1, N, M]`` if the caller already has it (built here
    otherwise).  ``state`` is a batch-1 :class:`FRState`; ``eps`` and
    ``nreductions`` pass through, ``optimal_found |= done``.  CPU
    tensors run :func:`fr_big_chunk_reference`; CUDA tensors launch the
    kernel."""
    check_state(values_t, state)
    if values_t.shape[0] != 1:
        raise ValueError(f"fr_big_chunk solves one instance, got a batch "
                         f"of {values_t.shape[0]}")
    if values_t.dtype != torch.float32:
        raise ValueError(f"fr_big_chunk takes float32 values, got "
                         f"{values_t.dtype}")
    if values_t.device.type == "cpu":
        return fr_big_chunk_reference(values_t, state, rounds, bid_rows)
    if values_t.device.type != "cuda":
        raise ValueError(f"fr_big_chunk runs on cpu or cuda, not "
                         f"{values_t.device}")
    return _fr_big_chunk_cuda(values_t, state, rounds, values, bid_rows)


def _fr_big_chunk_cuda(values_t, state, rounds, values, bid_rows):
    global LAUNCHES
    n = values_t.shape[2]
    vt = values_t.contiguous()
    v = (vt.transpose(1, 2) if values is None else values).contiguous()
    if v.shape != vt.shape or v.dtype != vt.dtype or v.device != vt.device:
        raise ValueError("values must be values_t's transpose")
    prices, profits, p2o, o2p, eps, meta = kernel_state(state, vt.dtype)
    check_bid_rows(bid_rows, 1, vt.device)
    lib = _kernel_lib()
    scratch = torch.zeros(int(lib.slap_fr_big_scratch_words(n)),
                          dtype=torch.int32, device=vt.device)
    with torch.cuda.device(vt.device):
        stream = torch.cuda.current_stream(vt.device).cuda_stream
        rc = lib.slap_fr_big_rounds(
            v.data_ptr(), vt.data_ptr(), prices.data_ptr(),
            profits.data_ptr(), p2o.data_ptr(), o2p.data_ptr(),
            eps.data_ptr(), meta.data_ptr(),
            bid_rows.data_ptr() if bid_rows is not None else None,
            scratch.data_ptr(), n, int(rounds), stream,
        )
    if rc != 0:
        msg = lib.slap_cuda_error_string(rc).decode()
        raise RuntimeError(f"big FR kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    new = state_from_kernel(state, prices, profits, p2o, o2p, meta)
    return new, new.done.all()
