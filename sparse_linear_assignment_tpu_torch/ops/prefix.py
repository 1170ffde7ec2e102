"""Prefix sums and stream compaction.

The port of the JAX package's ``ops/prefix.py``.  There the prefix sum
is a triangular matrix product on the MXU, a workaround for the TPU
compiler's trouble with scans; here it is ``torch.cumsum``.  The results
are the same integers: an inclusive count, exact at any length.
"""

from __future__ import annotations

import torch


def prefix_sum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a boolean or integer 1-D tensor, int32."""
    return torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32)


def compact_indices(mask: torch.Tensor, size: int):
    """Indices of the first ``size`` true positions in order, padded with
    0, and the total true count (a 0-dim int32 tensor): the output of
    the JAX package's ``compact_indices``."""
    n = mask.shape[0]
    pos = prefix_sum(mask)
    count = (pos[n - 1] if n > 0
             else torch.zeros((), dtype=torch.int32, device=mask.device))
    slot = pos - 1
    in_set = mask.to(torch.bool) & (slot < size)
    person = torch.arange(n, dtype=torch.int32, device=mask.device)
    # the persons out of the set go to a dump slot that is cut off;
    # the real slots are unique
    scat = torch.where(in_set, slot, size).long()
    ids = torch.zeros(size + 1, dtype=torch.int32, device=mask.device)
    ids.scatter_(0, scat, person)
    return ids[:size], count
