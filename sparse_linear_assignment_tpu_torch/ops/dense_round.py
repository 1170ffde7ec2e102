"""Forward-auction rounds of a batch on the card
(``csrc/dense_round_kernel.cu``): a whole chunk of rounds with the
eps-scaling bookkeeping in one launch, or one fused round with its
eps-CS margins.

Replaces the JAX package's Pallas TPU kernel ``_batch_round_kernel`` of
``ops/pallas_dense.py`` (driven by ``fused_dense_round_batch_flat`` and
``fused_dense_round_batch``, a grid over the batch), a body of
``_round_math``, together with the XLA bookkeeping that
``batch.py:_batch_chunk_pallas`` runs around each round.
:func:`fused_dense_chunk` runs up to ``chunk`` rounds of every instance
in one launch, each instance leaving the loop once it is done, and
returns the ``ForwardState`` that ``chunk`` rounds of
:func:`dense_chunk_reference` return, bit for bit.
:func:`fused_dense_round_batch` runs one round of the same kernel at
any ``B`` and returns its margins.  The single-instance round of the
same module in JAX (``_round_kernel``, ``fused_dense_round``) has a
kernel of its own: ``ops/dense_round_single.py``.

What bounds it on an H100.  A round reads the rows of its bidders (the
unassigned persons) and, in a round where an instance has just become
fully assigned on a square plane, every row once more for the margins;
a subtract and two compares per element, so the bytes bound it.  The
opening round of 4096 x (256 persons x 512 objects) float32 reads the
whole 2 GiB plane, about 0.64 ms at 3.35 TB/s; the rounds after it read
a few rows each, and there the round's latency sets the pace.  The
design:

- one CTA of 256 threads per instance; prices, one 64-bit conflict key
  per object, ``p2o``, each bidder's choice and the bidder list in
  shared memory for the whole launch (12 bytes per object, 12 per
  person), written back once at exit; ``o2p`` is updated in place;
- the person-major plane ``[B, N, M]`` (the sign-adjusted costs as they
  are, no transpose): a warp takes several bidders' contiguous rows at
  once in 16-byte loads, up to 8 loads a lane in flight, and merges the
  lanes' partial top-2s with the exact merge (equal profits to the
  smaller object, the loser's best into ``second``);
- bids meet in one ``atomicMax`` per bidder on the object's key
  (``csrc/fr_common.cuh:bid_key``): the largest bid, the smallest
  person among equal bids;
- the margins are computed only where the bookkeeping reads them (an
  instance that has just become fully assigned, ``N == M``);
- the bookkeeping in float32 with no fma (one ``__fmul_rn`` for the
  reduction of eps by ``0.15``); a finished instance returns at once;
- not carried over from the TPU kernel: the ``[B*8, N]`` sublane padding
  of the person vectors, the ``[M, 1]`` / ``[1, N]`` lane layouts, scalar
  prefetch, and the ``N % 128``, ``M % 8`` tiling limits.

Limits: float32 values; ``12 M + 12 N`` bytes of shared memory within
``MAX_SMEM_BYTES`` (about 19,000 objects).  Any ``N <= M``.

On CPU tensors the entry points run the plain PyTorch versions
:func:`dense_chunk_reference` and :func:`fused_dense_round_batch_reference`;
on CUDA tensors they launch the kernel or raise.  ``LAUNCHES`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..solution import UNASSIGNED
from . import _build
from .auction import ForwardState

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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.slap_dense_chunk.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, p,
            ctypes.c_float, ctypes.c_float, i, i, i, i, i, i, p,
        ]
        lib.slap_dense_chunk.restype = ctypes.c_int
        lib.slap_dense_round_error_string.argtypes = [ctypes.c_int]
        lib.slap_dense_round_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(n: int, m: int) -> int:
    """Shared memory the kernel needs for one ``n x m`` instance."""
    return 12 * m + 12 * n


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


def fused_dense_round_batch(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b,
                            vals_nm=None):
    """One fused forward-auction round of a whole batch: ``vals_b
    [B, M, N]`` (object-major, ``-inf`` at non-arcs), ``prices_b
    [B, M]``, ``p2o_b [B, N]`` int32, ``o2p_b [B, M]`` int32, ``eps_b
    [B]``, ``done_b [B]`` bool.  Only the unassigned persons of
    instances that are not done bid.  Returns ``(prices' [B, M], p2o'
    [B, N], o2p' [B, M], chosen [B, N], maxp [B, N])``, the last two the
    eps-CS margins of the updated state.  CPU tensors run
    :func:`fused_dense_round_batch_reference`; CUDA tensors launch the
    kernel (float32 only), which reads the person-major layout:
    ``vals_nm``, ``vals_b``'s transpose ``[B, N, M]`` if the caller has
    it (built here otherwise)."""
    if vals_b.device.type == "cpu":
        return fused_dense_round_batch_reference(
            vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b
        )
    _check(vals_b, prices_b, p2o_b, o2p_b, eps_b, done_b)
    if vals_b.device.type != "cuda":
        raise ValueError(f"the dense round runs on cpu or cuda, not "
                         f"{vals_b.device}")
    if vals_nm is None:
        vals_nm = vals_b.transpose(1, 2)
    elif tuple(vals_nm.shape) != tuple(vals_b.transpose(1, 2).shape):
        raise ValueError("vals_nm must be vals_b's transpose")
    b, m, n = vals_b.shape
    prices = prices_b.to(torch.float32).contiguous().clone()
    p2o = p2o_b.to(torch.int32).contiguous().clone()
    o2p = o2p_b.to(torch.int32).contiguous().clone()
    eps = eps_b.to(torch.float32).contiguous().clone()
    done = done_b.to(torch.bool).contiguous()
    chosen = torch.empty((b, n), dtype=torch.float32, device=vals_b.device)
    maxp = torch.empty_like(chosen)
    _launch(vals_nm, prices, p2o, o2p, eps, None, None, None, done,
            chosen, maxp, None, 0.0, 0.0, 0, 1, 0)
    return prices, p2o, o2p, chosen, maxp


def _check_chunk(vals_nm, states: ForwardState, rows) -> None:
    if vals_nm.dim() != 3:
        raise ValueError("vals_nm must be [B, N, M]")
    if not vals_nm.dtype.is_floating_point:
        raise ValueError(f"the forward chunk takes float values, got "
                         f"{vals_nm.dtype}")
    b, n, m = vals_nm.shape
    for name, want in (
        ("prices", (b, m)), ("p2o", (b, n)), ("o2p", (b, m)),
        ("eps", (b,)), ("nits", (b,)), ("nreductions", (b,)),
        ("optimal_found", (b,)), ("done", (b,)),
    ):
        t = getattr(states, name)
        if tuple(t.shape) != want:
            raise ValueError(f"states.{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.device != vals_nm.device:
            raise ValueError(f"states.{name} is on {t.device}, vals_nm "
                             f"on {vals_nm.device}")
    if rows is not None and (
        rows.dtype != torch.int64 or tuple(rows.shape) != (b,)
        or rows.device != vals_nm.device or not rows.is_contiguous()
    ):
        raise ValueError("rows must be a contiguous int64 [B] tensor on "
                         "the values' device")


def dense_chunk_reference(vals_nm, states: ForwardState, target_eps,
                          toleration, max_iterations: int, chunk: int,
                          sfoe: bool, rows=None):
    """Plain PyTorch version of the chunk kernel: ``chunk`` rounds of
    :func:`fused_dense_round_batch_reference` with the eps-scaling
    bookkeeping of the JAX package's ``_batch_chunk_pallas`` after each
    (``sfoe``: no eps-scaling, a full assignment stops).  Finished
    instances are frozen, so the loop stops once all are done.  The
    returned state's ``o2p`` is stale by design: keep-valid phases only
    ever write it.  ``rows [B]`` int64, if given, gains the rows each
    instance read: its bidders every round, and all ``N`` rows in a
    round that computes the margins.  Returns ``(states, alldone)``."""
    _check_chunk(vals_nm, states, rows)
    dtype, dev = vals_nm.dtype, vals_nm.device
    n = vals_nm.shape[1]
    vals_b = vals_nm.transpose(1, 2)
    target = torch.as_tensor(target_eps, dtype=dtype, device=dev)
    tol = torch.as_tensor(toleration, dtype=dtype, device=dev)
    factor = torch.tensor(0.15, dtype=dtype, device=dev)
    s = states
    for _ in range(chunk):
        if bool(s.done.all()):
            break
        if rows is not None:
            rows += ((s.p2o == _INT_MAX) & ~s.done[:, None]).sum(dim=1)
        prices, p2o, o2p, chosen, maxp = fused_dense_round_batch_reference(
            vals_b, s.prices, s.p2o, s.o2p, s.eps, s.done
        )
        nits = s.nits + (~s.done).to(torch.int32)
        num_unassigned = (p2o == _INT_MAX).sum(dim=1)
        fully = (num_unassigned == 0) & ~s.done
        if sfoe:
            is_optimal = torch.ones_like(fully)
        else:
            is_optimal = (chosen + tol >= maxp - target).all(dim=1)
            if rows is not None:
                rows += n * fully
        stop = is_optimal | (s.eps < target)
        reduce = fully & ~stop
        eps = torch.where(reduce, s.eps * factor, s.eps)
        # keep the pairs that satisfy eps-CS at the reduced eps
        release = reduce[:, None] & ~(
            (p2o != _INT_MAX) & (chosen + tol >= maxp - eps[:, None])
        )
        s = ForwardState(
            prices=prices,
            p2o=torch.where(release, _INT_MAX, p2o),
            o2p=o2p,
            eps=eps,
            nits=nits,
            nreductions=s.nreductions + reduce.to(torch.int32),
            optimal_found=s.optimal_found | (fully & is_optimal),
            done=s.done | (fully & stop) | (nits >= max_iterations),
        )
    return s, s.done.all()


def fused_dense_chunk(vals_nm, states: ForwardState, target_eps, toleration,
                      max_iterations: int, chunk: int, sfoe: bool,
                      rows=None):
    """Up to ``chunk`` forward-auction rounds of every instance with the
    eps-scaling bookkeeping, in one launch: ``vals_nm [B, N, M]``
    person-major (the sign-adjusted costs, ``-inf`` at non-arcs),
    ``states`` a batched ``ForwardState``.  Returns ``(states,
    alldone)``, bit-equal to :func:`dense_chunk_reference`, which CPU
    tensors run; CUDA tensors launch the kernel (float32 only).
    ``rows`` as there."""
    _check_chunk(vals_nm, states, rows)
    if vals_nm.device.type == "cpu":
        return dense_chunk_reference(vals_nm, states, target_eps,
                                     toleration, max_iterations, chunk,
                                     sfoe, rows)
    if vals_nm.device.type != "cuda":
        raise ValueError(f"the forward chunk runs on cpu or cuda, not "
                         f"{vals_nm.device}")
    prices = states.prices.to(torch.float32).contiguous().clone()
    p2o = states.p2o.to(torch.int32).contiguous().clone()
    o2p = states.o2p.to(torch.int32).contiguous().clone()
    eps = states.eps.to(torch.float32).contiguous().clone()
    nits = states.nits.to(torch.int32).contiguous().clone()
    nred = states.nreductions.to(torch.int32).contiguous().clone()
    optimal = states.optimal_found.to(torch.bool).contiguous().clone()
    done = states.done.to(torch.bool).contiguous().clone()
    _launch(vals_nm, prices, p2o, o2p, eps, nits, nred, optimal, done,
            None, None, rows, float(target_eps), float(toleration),
            int(max_iterations), int(chunk), int(bool(sfoe)))
    new = ForwardState(prices=prices, p2o=p2o, o2p=o2p, eps=eps, nits=nits,
                       nreductions=nred, optimal_found=optimal, done=done)
    return new, done.all()


def _launch(vals_nm, prices, p2o, o2p, eps, nits, nred, optimal, done,
            chosen, maxp, rows, target, tol, max_iterations, chunk, sfoe):
    global LAUNCHES
    if vals_nm.dtype != torch.float32:
        raise ValueError(f"the dense round kernel takes float32 values, got "
                         f"{vals_nm.dtype}; other types run the plain "
                         f"versions")
    b, n, m = vals_nm.shape
    need = smem_bytes(n, m)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {n}x{m} instance needs {need} bytes of shared memory "
            f"(12 per object, 12 per person), more than the "
            f"{MAX_SMEM_BYTES} a block can use"
        )
    dev = vals_nm.device
    vals = vals_nm.contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slap_dense_chunk(
            vals.data_ptr(), prices.data_ptr(), p2o.data_ptr(),
            o2p.data_ptr(), eps.data_ptr(), ptr(nits), ptr(nred),
            ptr(optimal), done.data_ptr(), ptr(chosen), ptr(maxp),
            ptr(rows), target, tol, max_iterations, chunk, sfoe, b, n, m,
            stream,
        )
    if rc != 0:
        msg = lib.slap_dense_round_error_string(rc).decode()
        raise RuntimeError(f"dense round kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
