"""PyTorch/CUDA port of ``sparse_linear_assignment_tpu``.

Batched dense linear assignment through the forward-reverse auction,
on an NVIDIA H100 through a hand-written CUDA kernel
(``csrc/fr_kernel.cu``, built with ``nvcc`` at first use), or on the
CPU through the kernel's plain PyTorch version when the caller passes
``device="cpu"``.

The port imports ``torch``, ``numpy`` and ``scipy`` only: nothing of
JAX and nothing of the JAX package.  Importing it changes no global
configuration.
"""

from .batch import (
    BatchedLAP,
    BatchSolution,
    linear_sum_assignment,
    solve_batch,
    solve_batch_stream,
)
from .ops.fr_dense import state_to_numpy, weights_from_jax_state
from .solution import UNASSIGNED, convert_indices

__all__ = [
    "BatchSolution",
    "BatchedLAP",
    "UNASSIGNED",
    "convert_indices",
    "linear_sum_assignment",
    "solve_batch",
    "solve_batch_stream",
    "state_to_numpy",
    "weights_from_jax_state",
]
