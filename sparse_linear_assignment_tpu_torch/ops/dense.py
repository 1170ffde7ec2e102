"""Dense problem representation: gather-free auction rounds.

For dense instances (every person connected to every object, or a
densified sparse instance with ``-inf`` at its non-arcs) every lookup of
an auction round is a broadcast and a masked reduction over the value
matrix.  As everywhere in the port, ``vmap`` is written out as a leading
batch dimension.
"""

from __future__ import annotations

import torch


class DenseProblem:
    """A batch of dense LAP instances: ``vals_t [B, M, N]`` holds the
    value of (object ``j``, person ``u``) at ``[b, j, u]``, the
    transposed cost matrix.  Any strides are accepted, so the transposed
    view of a person-major ``[B, N, M]`` plane serves without a copy."""

    def __init__(self, vals_t: torch.Tensor):
        if vals_t.dim() != 3:
            raise ValueError("vals_t must be [B, M, N]")
        self.vals_t = vals_t

    @property
    def dtype(self) -> torch.dtype:
        return self.vals_t.dtype

    @property
    def num_rows(self) -> int:
        return self.vals_t.shape[2]

    @property
    def num_cols(self) -> int:
        return self.vals_t.shape[1]
