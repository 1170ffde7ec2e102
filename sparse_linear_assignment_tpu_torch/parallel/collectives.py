"""Collectives of the sharded modes over a 1-D ``torch.distributed``
process group.

The JAX package's sharded programs run under ``shard_map`` on a 1-D
mesh axis and talk through ``lax.all_gather(tiled=True)``, ``pmax``,
``pmin`` and ``psum``.  Here the mesh is a process group, the shard
index is the rank in it, and these four are :func:`all_gather_tiled`
and :func:`all_reduce` with ``"max"``, ``"min"`` and ``"sum"``:

- each returns a new tensor, so no state is ever reduced in place;
- bool travels as int32, since neither NCCL nor gloo reduces bool;
- each call adds one to ``COUNTS`` under its kind, which the collective
  audit reads (``parallel/sharded.py``'s table).  A CUDA graph's replay
  runs its captured collectives without a call from Python and adds
  nothing.

The group's backend must fit the device of the tensors: NCCL for CUDA
tensors, gloo for CPU tensors (:func:`rank_device`).  Nothing here
creates a group: the caller initialises one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device

#: collective calls made in this process, by kind
COUNTS = {"all_gather": 0, "max": 0, "min": 0, "sum": 0}

_REDUCE_OPS = {
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
    "sum": dist.ReduceOp.SUM,
}

#: the backend that each device type's tensors need
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def reset_counts() -> None:
    for kind in COUNTS:
        COUNTS[kind] = 0


def rank_device(group, device) -> torch.device:
    """The device of this rank's shard: ``device=None`` means
    ``cuda:{torch.cuda.current_device()}`` (and raises without a card),
    ``"cpu"`` the host.  Raises ``ValueError`` when no process group is
    initialised or when the group's backend does not fit the device
    (NCCL for CUDA, gloo for the CPU): a shard never moves through host
    copies to suit the group."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise ValueError(
            "no process group: call torch.distributed.init_process_group "
            "before a sharded solve"
        )
    backend = str(dist.get_backend(group))
    want = _BACKENDS.get(dev.type)
    if backend != want:
        raise ValueError(
            f"{dev.type} tensors need a {want} process group; this group's "
            f"backend is {backend}"
        )
    return dev


def shard_index(group) -> tuple[int, int]:
    """``(rank, world size)`` of this process in ``group``: the shard it
    holds and the number of shards."""
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather_tiled(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dimension 0 in rank order
    (``lax.all_gather(x, axis, tiled=True)``).  Every rank's ``x`` has
    the same shape."""
    COUNTS["all_gather"] += 1
    wire = x.to(torch.int32) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def all_gather_parts(parts, group=None) -> list:
    """Several tensors, each sharded on its first dimension, gathered
    tiled in ONE :func:`all_gather_tiled` of int32 words (the JAX
    package's packed readback of a sharded result).  Any dtypes; every
    rank's ``parts`` have the same shapes."""
    words, metas = [], []
    for p in parts:
        w = p.to(torch.int32) if p.dtype == torch.bool else p
        flat = w.contiguous().reshape(-1).view(torch.int32)
        words.append(flat)
        metas.append((p.dtype, w.dtype, tuple(p.shape), flat.numel()))
    world = dist.get_world_size(group)
    plane = all_gather_tiled(torch.cat(words), group).reshape(world, -1)
    out, at = [], 0
    for dtype, wire, shape, n in metas:
        # a copy: a view of a wider type needs its own aligned storage
        block = plane[:, at:at + n].reshape(-1).clone().view(wire)
        block = block.reshape((world * shape[0],) + shape[1:])
        out.append(block.bool() if dtype == torch.bool else block)
        at += n
    return out


def all_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """The elementwise ``op`` (``"max"``, ``"min"`` or ``"sum"``) of
    every rank's ``x`` as a new tensor (``pmax``, ``pmin``, ``psum``)."""
    COUNTS[op] += 1
    wire = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
    dist.all_reduce(wire, op=_REDUCE_OPS[op], group=group)
    return wire.bool() if x.dtype == torch.bool else wire
