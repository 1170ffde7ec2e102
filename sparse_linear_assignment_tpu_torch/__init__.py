"""PyTorch/CUDA port of ``sparse_linear_assignment_tpu``.

Batched linear assignment on an NVIDIA H100 through hand-written CUDA
kernels (``csrc/*.cu``, built with ``nvcc`` at first use), or on the CPU
through the kernels' plain PyTorch versions when the caller passes
``device="cpu"``:

- dense instances through the forward-reverse auction: ``solve_batch``,
  ``solve_batch_stream``, ``linear_sum_assignment``, ``BatchedLAP``
  (``csrc/fr_kernel.cu``; big singles on ``csrc/fr_big_kernel.cu``);
  rectangular instances and ``solver="forward"`` through the forward
  auction on the fused round kernel (``csrc/dense_round_kernel.cu``),
  ``solver="khosla"`` and other float types on the plain rounds;
- k-sparse instances through the Khosla auction on a densified plane:
  ``solve_batch_sparse``, ``stage_batch_sparse``,
  ``stage_batch_sparse_device``, ``solve_batch_sparse_stream``
  (``csrc/ksp_kernel.cu``); ``generators.gen_batch_ksparse`` makes
  seeded instances.

The port imports ``torch``, ``numpy`` and ``scipy`` only: nothing of
JAX and nothing of the JAX package.  Importing it changes no global
configuration.
"""

from . import generators
from .batch import (
    BatchedLAP,
    BatchSolution,
    linear_sum_assignment,
    solve_batch,
    solve_batch_sparse,
    solve_batch_sparse_stream,
    solve_batch_stream,
    stage_batch_sparse,
    stage_batch_sparse_device,
)
from .ops.auction import (
    forward_state_from_jax,
    forward_state_to_numpy,
    khosla_state_from_jax,
    khosla_state_to_numpy,
)
from .ops.fr_dense import state_to_numpy, weights_from_jax_state
from .solution import UNASSIGNED, convert_indices

__all__ = [
    "BatchSolution",
    "BatchedLAP",
    "UNASSIGNED",
    "convert_indices",
    "forward_state_from_jax",
    "forward_state_to_numpy",
    "generators",
    "khosla_state_from_jax",
    "khosla_state_to_numpy",
    "linear_sum_assignment",
    "solve_batch",
    "solve_batch_sparse",
    "solve_batch_sparse_stream",
    "solve_batch_stream",
    "stage_batch_sparse",
    "stage_batch_sparse_device",
    "state_to_numpy",
    "weights_from_jax_state",
]
