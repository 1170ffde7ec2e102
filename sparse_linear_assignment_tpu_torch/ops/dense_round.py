"""Fused dense forward-auction round (``csrc/dense_round_kernel.cu``).

Replaces the JAX package's two Pallas TPU kernels of
``ops/pallas_dense.py``: ``_batch_round_kernel`` (driven by
``fused_dense_round_batch_flat`` and ``fused_dense_round_batch``, a grid
over the batch) and ``_round_kernel`` (``fused_dense_round``, one
instance), both bodies of ``_round_math``.  One launch runs one round of
every instance of a batch: bidding, conflict resolution with the
smallest-person tie rule, assignment, and the eps-CS margins of the
updated state that the eps-scaling bookkeeping of
``batch._batch_chunk_kernel`` reads.  :func:`fused_dense_round` is the
same kernel at ``B = 1``: one CTA for the instance.

What bounds it on an H100.  A round reads the object-major plane
``vals_b [B, M, N]`` and does a subtract and two compares per element:
2 GiB at 4096 x (256 persons x 512 objects) float32, about 0.64 ms at
3.35 TB/s against 0.03 ms of arithmetic, so the bytes bound it.  One
256 x 512 instance is 512 KB, more than the 227 KB of shared memory a
block can use, so the plane stays in device memory and the margins at
the new prices need a second pass over it (from L2 where it still holds
the instance).  The design:

- one CTA of 256 threads per instance; prices, one 64-bit conflict key
  per object, ``p2o`` and each person's choice in shared memory (12
  bytes per object, 8 per person, 4 KB of merge scratch);
- threads as ``W`` person lanes by ``S`` row splits (``W * S = 256``):
  a lane walks one person's column, a warp's loads are coalesced along
  the contiguous person axis, and with fewer than 256 persons the ``M``
  rows are split over ``S`` threads a person and merged with the exact
  top-2 merge (equal profits to the smaller object, the loser's best
  into ``second``);
- bids meet in one ``atomicMax`` per bidder on the object's key
  (``csrc/fr_common.cuh:bid_key``): the largest bid, the smallest
  person among equal bids;
- an instance that is done skips the bidding pass and reads the plane
  once, for its margins;
- not carried over from the TPU kernel: the ``[B*8, N]`` sublane padding
  of the person vectors, the ``[M, 1]`` / ``[1, N]`` lane layouts, scalar
  prefetch, and the ``N % 128``, ``M % 8`` tiling limits.

Limits: float32 values; ``12 M + 8 N + 4096`` bytes of shared memory
within ``MAX_SMEM_BYTES`` (about 19,000 objects).  Any ``N <= M``.

On CPU tensors the entry points run the plain PyTorch version
:func:`fused_dense_round_batch_reference`; on CUDA tensors they launch
the kernel or raise.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..solution import UNASSIGNED
from . import _build

#: kernel launches made by the entry points in this process
LAUNCHES = 0

#: shared memory one block can use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

_INT_MAX = UNASSIGNED
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("dense_round_kernel")
        p = ctypes.c_void_p
        lib.slap_dense_round.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
        ]
        lib.slap_dense_round.restype = ctypes.c_int
        lib.slap_dense_round_error_string.argtypes = [ctypes.c_int]
        lib.slap_dense_round_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(n: int, m: int) -> int:
    """Shared memory the kernel needs for one ``n x m`` instance."""
    return 12 * m + 8 * n + 4096


def kernel_fits(n: int, m: int) -> bool:
    """Whether one ``n x m`` instance's state fits a block's shared
    memory, the kernel's only limit of shape."""
    return smem_bytes(n, m) <= MAX_SMEM_BYTES


def _check(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b) -> None:
    if vals_b.dim() != 3:
        raise ValueError("vals_b must be [B, M, N]")
    if not vals_b.dtype.is_floating_point:
        raise ValueError(f"the dense round takes float values, got "
                         f"{vals_b.dtype}")
    b, m, n = vals_b.shape
    for name, t, want in (
        ("prices_b", prices_b, (b, m)),
        ("p2o_b", p2o_b, (b, n)),
        ("o2p_b", o2p_b, (b, m)),
        ("eps_b", eps_b, (b,)),
        ("done_b", done_b, (b,)),
    ):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.device != vals_b.device:
            raise ValueError(f"{name} is on {t.device}, vals_b on "
                             f"{vals_b.device}")


def fused_dense_round_batch_reference(vals_b, prices_b, p2o_b, o2p_b, eps_b,
                                      done_b):
    """Plain PyTorch version of the kernel, ``_round_math`` of the JAX
    module step by step with the batch as a leading dimension.  Any
    float dtype.  Returns ``(prices', p2o', o2p', chosen, maxp)``."""
    _check(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b)
    dtype, dev = vals_b.dtype, vals_b.device
    _, m, n = vals_b.shape
    neg_inf = torch.tensor(-np.inf, dtype=dtype, device=dev)
    j_iota = torch.arange(m, dtype=torch.int32, device=dev)[None, :, None]
    u_iota = torch.arange(n, dtype=torch.int32, device=dev)[None, None, :]
    prices = prices_b[:, :, None]                               # [B, M, 1]
    p2o = p2o_b[:, None, :]                                     # [B, 1, N]
    eps = eps_b.to(dtype)[:, None, None]
    not_done = ~done_b.to(torch.bool)[:, None, None]

    profit = vals_b - prices                                    # [B, M, N]

    # bidding: per-person top-2 profit over the objects
    best = profit.amax(dim=1, keepdim=True)                     # [B, 1, N]
    is_best = profit == best
    best_j = torch.where(is_best, j_iota, m).amin(dim=1, keepdim=True)
    sel = j_iota == best_j
    second = torch.where(sel, neg_inf, profit).amax(dim=1, keepdim=True)
    best_val = torch.where(sel, vals_b, neg_inf).amax(dim=1, keepdim=True)

    unassigned = (p2o == _INT_MAX) & not_done
    has_second = second != neg_inf
    price_at_best = best_val - best
    raw_bid = torch.where(
        has_second, best_val - second + eps, price_at_best + eps
    )
    bid = torch.where(unassigned & (best != neg_inf), raw_bid, neg_inf)

    # conflict: per-object largest bid, smallest person among equal bids
    is_here = sel & (bid != neg_inf)                            # [B, M, N]
    eff = torch.where(is_here, bid, neg_inf)
    max_bid = eff.amax(dim=2, keepdim=True)                     # [B, M, 1]
    has_winner = max_bid != neg_inf
    cand = torch.where(is_here & (eff >= max_bid), u_iota, _INT_MAX)
    winner = cand.amin(dim=2, keepdim=True)

    prices_new = torch.where(has_winner, max_bid, prices)
    o2p_new = torch.where(has_winner, winner, o2p_b[:, :, None])

    won = (is_here & (winner == u_iota)).any(dim=1, keepdim=True)
    assigned = p2o != _INT_MAX
    displaced = assigned & ((p2o == j_iota) & has_winner).any(
        dim=1, keepdim=True
    )
    p2o_new = torch.where(
        won, best_j, torch.where(displaced, _INT_MAX, p2o)
    )

    # eps-CS margins of the updated state
    profit2 = vals_b - prices_new
    maxp = profit2.amax(dim=1)
    is_chosen = p2o_new == j_iota
    chosen = torch.where(is_chosen, profit2, neg_inf).amax(dim=1)
    return (prices_new[:, :, 0], p2o_new[:, 0, :], o2p_new[:, :, 0],
            chosen, maxp)


def fused_dense_round_batch(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b):
    """One fused forward-auction round of a whole batch: ``vals_b
    [B, M, N]`` (object-major, ``-inf`` at non-arcs), ``prices_b
    [B, M]``, ``p2o_b [B, N]`` int32, ``o2p_b [B, M]`` int32, ``eps_b
    [B]``, ``done_b [B]`` bool.  Only the unassigned persons of
    instances that are not done bid.  Returns ``(prices' [B, M], p2o'
    [B, N], o2p' [B, M], chosen [B, N], maxp [B, N])``, the last two the
    eps-CS margins of the updated state.  CPU tensors run
    :func:`fused_dense_round_batch_reference`; CUDA tensors launch the
    kernel (float32 only)."""
    if vals_b.device.type == "cpu":
        return fused_dense_round_batch_reference(
            vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b
        )
    _check(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b)
    if vals_b.device.type != "cuda":
        raise ValueError(f"the dense round runs on cpu or cuda, not "
                         f"{vals_b.device}")
    return _round_cuda(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b)


def fused_dense_round(vals_t, prices, p2o, o2p, eps, done):
    """One fused forward-auction round of a single dense instance:
    ``vals_t [M, N]``, ``prices [M]``, ``p2o [N]``, ``o2p [M]``, ``eps``
    a scalar, ``done`` a bool.  The batch entry point at ``B = 1``.
    Returns ``(prices', p2o', o2p', chosen_profit, max_profit)``."""
    dev = vals_t.device
    out = fused_dense_round_batch(
        vals_t[None], prices[None], p2o[None], o2p[None],
        torch.as_tensor(eps, dtype=vals_t.dtype, device=dev).reshape(1),
        torch.as_tensor(done, dtype=torch.bool, device=dev).reshape(1),
    )
    return tuple(x[0] for x in out)


def _round_cuda(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b):
    global LAUNCHES
    b, m, n = vals_b.shape
    if vals_b.dtype != torch.float32:
        raise ValueError(f"the dense round kernel takes float32 values, got "
                         f"{vals_b.dtype}; other types run "
                         f"fused_dense_round_batch_reference")
    need = smem_bytes(n, m)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {n}x{m} instance needs {need} bytes of shared memory "
            f"(12 per object, 8 per person, 4096 of scratch), more than "
            f"the {MAX_SMEM_BYTES} a block can use"
        )
    dev = vals_b.device
    vals = vals_b.contiguous()
    prices = prices_b.to(torch.float32).contiguous()
    p2o = p2o_b.to(torch.int32).contiguous()
    o2p = o2p_b.to(torch.int32).contiguous()
    eps = eps_b.to(torch.float32).contiguous()
    done = done_b.to(torch.bool).contiguous()
    prices_out = torch.empty((b, m), dtype=torch.float32, device=dev)
    p2o_out = torch.empty((b, n), dtype=torch.int32, device=dev)
    o2p_out = torch.empty((b, m), dtype=torch.int32, device=dev)
    chosen = torch.empty((b, n), dtype=torch.float32, device=dev)
    maxp = torch.empty((b, n), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slap_dense_round(
            vals.data_ptr(), prices.data_ptr(), p2o.data_ptr(),
            o2p.data_ptr(), eps.data_ptr(), done.data_ptr(),
            prices_out.data_ptr(), p2o_out.data_ptr(), o2p_out.data_ptr(),
            chosen.data_ptr(), maxp.data_ptr(), b, n, m, stream,
        )
    if rc != 0:
        msg = lib.slap_dense_round_error_string(rc).decode()
        raise RuntimeError(f"dense round kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return prices_out, p2o_out, o2p_out, chosen, maxp
