"""Seeded random problem generators (NumPy only).

The port's own copy of what it needs from the JAX package's
``generators.py``: the same seeds give the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np


def gen_batch_ksparse(
    seed: int,
    b: int,
    n: int,
    m: int,
    k: int,
    min_value: float = 300.0,
    range_width: float = 700.0,
):
    """Batched k-regular sparse instances for ``solve_batch_sparse``:
    ``columns[B, N, K]`` (k distinct objects per person, sorted) and
    ``values[B, N, K]`` (Beta(3,3) integer-floored, scaled to
    [min_value, min_value + range_width): the reference crate's
    asymmetric bench value distribution, batched).

    Vectorized: argpartition over chunked random keys samples every
    row's k distinct columns without a Python loop over rows.
    """
    val_rng = np.random.default_rng(seed)
    filter_rng = np.random.default_rng(seed + 1)
    cols = np.empty((b, n, k), dtype=np.int32)
    chunk = max(1, (1 << 27) // max(1, n * m))  # ~512 MB of f32 keys
    for s in range(0, b, chunk):
        e = min(b, s + chunk)
        keys = filter_rng.random((e - s, n, m), dtype=np.float32)
        part = np.argpartition(keys, k - 1, axis=2)[:, :, :k]
        cols[s:e] = np.sort(part, axis=2).astype(np.int32)
    vals = np.floor(
        range_width * val_rng.beta(3.0, 3.0, size=(b, n, k)) + min_value
    )
    return cols, vals
