"""Index conventions of the assignment results.

A NumPy-only copy of the JAX package's ``solution.py`` conventions
(the port imports nothing of that package): ``int32`` indices with
``UNASSIGNED == 2**31 - 1`` marking an unassigned person or object.
"""

from __future__ import annotations

import numpy as np

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


def o2p_from_p2o(p2o: np.ndarray, num_cols: int) -> np.ndarray:
    """Object→person from person→object (the matching is injective on
    assigned pairs, so the inverse is exact).  Accepts ``[N]`` or
    batched ``[B, N]``; unmatched objects get ``UNASSIGNED``."""
    p2o = np.asarray(p2o)
    batched = p2o.ndim == 2
    p2o2 = p2o if batched else p2o[None, :]
    o2p = np.full((p2o2.shape[0], num_cols), UNASSIGNED, dtype=np.int32)
    rows, cols = np.nonzero(p2o2 != UNASSIGNED)
    o2p[rows, p2o2[rows, cols]] = cols
    return o2p if batched else o2p[0]
