"""The solution object and the index conventions of the results.

A copy of the JAX package's ``solution.py`` (the port imports nothing
of that package): ``int32`` indices with ``UNASSIGNED == 2**31 - 1``
marking an unassigned person or object, the role of the reference
crate's ``I::max_value()``.  In place of its NumPy inversion,
:func:`o2p_from_p2o_device` builds object→person and the unassigned
counts with PyTorch on the matching's device, inside a profiler span.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .utils.trace import INVERT_SPAN, span

#: sentinel for unassigned persons/objects (the reference's
#: ``I::max_value()`` for the int32 index type)
UNASSIGNED: int = np.iinfo(np.int32).max

INDEX_DTYPE = np.int32

def unassigned_value(index_dtype=INDEX_DTYPE) -> int:
    """The UNASSIGNED sentinel for an index dtype: ``2**31 - 1`` for
    int32, ``65535`` for uint16, ``2**32 - 1`` for uint32."""
    return int(np.iinfo(np.dtype(index_dtype)).max)


def convert_indices(arr: np.ndarray, index_dtype) -> np.ndarray:
    """Convert an int32 assignment array to another index width,
    remapping the ``UNASSIGNED`` sentinel to the target dtype's max.
    Raises ``ValueError`` if a real index does not fit (sentinel
    excluded)."""
    dt = np.dtype(index_dtype)
    arr = np.asarray(arr)
    sent = unassigned_value(dt)
    real = arr != UNASSIGNED
    if real.any():
        hi = int(arr[real].max())
        lo = int(arr[real].min())
        if hi >= sent or lo < 0:
            raise ValueError(
                f"index {hi if hi >= sent else lo} does not fit "
                f"{dt.name} (sentinel {sent})"
            )
    return np.where(real, arr, sent).astype(dt)


@dataclasses.dataclass
class AuctionSolution:
    """Result of a linear assignment solve (the reference crate's
    ``AuctionSolution<I>``):

    - ``person_to_object[i]``: the object person ``i`` owns
      (``UNASSIGNED`` if none);
    - ``object_to_person[j]``: the person owning object ``j``
      (``UNASSIGNED`` if unowned);
    - ``num_unassigned``: unassigned persons (a perfect matching iff 0);
    - ``eps``: the eps at which the solution was found; eps-optimal if a
      perfect matching exists.
    """

    person_to_object: np.ndarray
    object_to_person: np.ndarray
    num_unassigned: int
    eps: float

    @classmethod
    def new(cls, row_capacity: int = 0,
            column_capacity: int = 0) -> "AuctionSolution":
        """A fresh solution in the reference's initial state: empty
        assignment arrays, ``num_unassigned`` at the sentinel,
        ``eps = NaN``.  The capacity hints are unused here: every solve
        builds new assignment arrays (a caller may hold the previous
        ones); the solver's CSR storage takes its own hints."""
        del row_capacity, column_capacity
        return cls(
            person_to_object=np.zeros(0, dtype=INDEX_DTYPE),
            object_to_person=np.zeros(0, dtype=INDEX_DTYPE),
            num_unassigned=UNASSIGNED,
            eps=math.nan,
        )

    def astype_index(self, index_dtype) -> "AuctionSolution":
        """A copy with both assignment arrays in another index width
        (u16, u32), the sentinel remapped to the target's maximum; see
        :func:`convert_indices`."""
        return AuctionSolution(
            person_to_object=convert_indices(self.person_to_object,
                                             index_dtype),
            object_to_person=convert_indices(self.object_to_person,
                                             index_dtype),
            num_unassigned=self.num_unassigned,
            eps=self.eps,
        )


def o2p_from_p2o_device(p2o: torch.Tensor,
                        num_cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Object→person from person→object on the matching's own device:
    from an int32 ``[B, N]`` tensor, object→person ``[B, num_cols]``
    (``UNASSIGNED`` for unowned objects) and the unassigned persons
    ``[B]``, both int32 tensors on that device.  Equal bit for bit to the
    JAX package's NumPy inversion, where persons name one object too:
    the highest person index wins, as NumPy's last write does (``amax``,
    which, unlike a plain scatter, is deterministic on CUDA).  Unassigned
    persons scatter into a dummy column ``num_cols``, sliced off."""
    with span(INVERT_SPAN):
        b, n = p2o.shape
        idx = p2o.to(torch.int64)
        free = idx == UNASSIGNED
        idx.masked_fill_(free, num_cols)
        num_unassigned = free.sum(dim=1, dtype=torch.int32)
        # each transient freed before the next allocation: a caller's
        # finish runs near its peak memory
        del free
        o2p = torch.full((b, num_cols + 1), -1, dtype=torch.int32,
                         device=p2o.device)
        persons = torch.arange(n, dtype=torch.int32, device=p2o.device)
        o2p.scatter_reduce_(1, idx, persons.expand(b, n), "amax")
        del idx
        o2p = o2p[:, :num_cols]
        return torch.where(o2p < 0, UNASSIGNED, o2p), num_unassigned
