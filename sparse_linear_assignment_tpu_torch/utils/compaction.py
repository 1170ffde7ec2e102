"""Host-side unassigned-list compaction (a utility of the reference crate).

The reference crate keeps its forward solver's unassigned-person list
dense by moving the valid ids left of the ``I::MAX`` sentinels after
every round and updating the inverse position map in tandem
(``push_all_left``).  The port's rounds use a boolean mask instead (or
the slot list of ``ops/compact.py``); this is the literal utility, with
the reference's contract and cursor walk, for callers porting code from
the crate.  A NumPy-only copy of the JAX package's module.
"""

from __future__ import annotations

import numpy as np


def push_all_left(data, mapper, num_ints: int, size: int) -> None:
    """Move the valid ids of ``data`` left of the sentinels, in place,
    updating ``mapper`` in tandem.

    - ``data`` holds ``num_ints`` valid ids; every other entry is the
      dtype's maximum (the sentinel).
    - ``mapper[i]`` is the position of id ``i`` in ``data`` and is kept
      right for every id that moves.
    - ``size`` bounds the right-hand scan (``right < size``); the right
      cursor starts at ``num_ints``.
    - The order of the ids is the reference's cursor walk, e.g.
      ``[MAX, 1, 2, 3, MAX, MAX] -> [3, 1, 2, MAX, MAX, MAX]``.

    Both arrays must be mutable 1-D integer ndarrays of one dtype."""
    data = np.asarray(data)
    mapper = np.asarray(mapper)
    if data.ndim != 1 or mapper.ndim != 1:
        raise ValueError("push_all_left expects 1-D arrays")
    if data.dtype != mapper.dtype:
        raise ValueError(
            f"data/mapper dtypes differ: {data.dtype} vs {mapper.dtype}"
        )
    if not np.issubdtype(data.dtype, np.integer):
        raise ValueError(f"integer arrays required, got {data.dtype}")
    sentinel = np.iinfo(data.dtype).max
    if num_ints == 0:
        return

    left = 0
    right = num_ints
    while left < num_ints:
        if data[left] == sentinel:
            while right < size and data[right] == sentinel:
                right += 1
            # as in the reference: when the scan stops at ``size`` the
            # entry there is taken as it is (callers keep a valid id in
            # range; the bound only limits the scan)
            i = data[right]
            data[left] = i
            data[right] = sentinel
            mapper[int(i)] = left
        left += 1
