"""Sharded solves over a ``torch.distributed`` process group (the port
of the JAX package's ``parallel``)."""

from .sharded import (
    sharded_forward_core,
    sharded_fr_batch_core,
    sharded_fr_dense_core,
    sharded_khosla_core,
    solve_batch_sharded,
    solve_batch_sharded_stream,
    solve_batch_sparse_sharded,
    solve_fr_dense_sharded,
    solve_sharded_forward,
    solve_sharded_khosla,
)

__all__ = [
    "sharded_forward_core",
    "sharded_fr_batch_core",
    "sharded_fr_dense_core",
    "sharded_khosla_core",
    "solve_batch_sharded",
    "solve_batch_sharded_stream",
    "solve_batch_sparse_sharded",
    "solve_fr_dense_sharded",
    "solve_sharded_forward",
    "solve_sharded_khosla",
]
