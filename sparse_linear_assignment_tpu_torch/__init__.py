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
  (``csrc/ksp_kernel.cu``; past its shared memory, on the arcs
  themselves, ``csrc/ksp_arcs_kernel.cu``), or on the padded gather rounds
  (``solve_batch_sparse(engine="padded")``); ``generators`` makes
  seeded instances;
- the reference crate's API for one sparse instance:
  ``AuctionSolver`` (CSR builder, objective, eps-CS certificate),
  ``KhoslaSolver``, ``ForwardAuctionSolver``, ``AuctionSolution``, on
  the native C++ engine (``cpu_reference.py``) or the device engines
  (``ops/auction.py``, ``ops/compact.py``, ``hybrid.py``; plain
  PyTorch, as the JAX package's are plain XLA).

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
from .ops.compact import lstate_from_jax, lstate_to_numpy
from .ops.fr_dense import state_to_numpy, weights_from_jax_state
from .ops.padded import padded_problem_from_numpy
from .ksparse import KhoslaSolver
from .solution import (
    INDEX_DTYPE,
    UNASSIGNED,
    AuctionSolution,
    convert_indices,
    unassigned_value,
)
from .solver import AuctionSolver
from .symmetric import ForwardAuctionSolver

__all__ = [
    "AuctionSolution",
    "AuctionSolver",
    "BatchSolution",
    "BatchedLAP",
    "ForwardAuctionSolver",
    "INDEX_DTYPE",
    "KhoslaSolver",
    "UNASSIGNED",
    "convert_indices",
    "forward_state_from_jax",
    "forward_state_to_numpy",
    "generators",
    "khosla_state_from_jax",
    "khosla_state_to_numpy",
    "linear_sum_assignment",
    "lstate_from_jax",
    "lstate_to_numpy",
    "padded_problem_from_numpy",
    "solve_batch",
    "solve_batch_sparse",
    "solve_batch_sparse_stream",
    "solve_batch_stream",
    "stage_batch_sparse",
    "stage_batch_sparse_device",
    "state_to_numpy",
    "unassigned_value",
    "weights_from_jax_state",
]
