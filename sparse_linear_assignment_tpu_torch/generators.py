"""Seeded random problem generators (NumPy only).

The port's own copy of the JAX package's ``generators.py``: the same
seeds give the same arrays in both packages.  The semantics are the
reference crate's bench generators (``benches/benchmark.rs``) on NumPy
random streams, so instances are reproducible here but differ from the
crate's own.
"""

from __future__ import annotations

import numpy as np


def gen_symmetric_input(
    solver,
    seed: int,
    size: int,
    density: float,
    min_value: float,
    max_value: float,
    value_seed=None,
) -> None:
    """Square instance: Bernoulli(``density``) arcs plus a shuffled
    ensured perfect matching, values U[min_value, max_value).

    ``value_seed`` (default ``seed``) decouples the value stream from
    the arc structure: a fixed ``seed`` with varying ``value_seed``
    varies the costs and keeps the padded shapes."""
    val_rng = np.random.default_rng(
        seed if value_seed is None else value_seed
    )
    filter_rng = np.random.default_rng(seed + 1)

    ensured = filter_rng.permutation(size)
    solver.init(size, size)
    if size > 4096:
        # large instances, vectorised: per-row arc counts
        # Binomial(size, density), positions drawn with replacement and
        # deduplicated through a sorted (row, col) key (the same
        # distribution family as the Bernoulli sweep, another stream)
        n_extra = filter_rng.binomial(size, density, size=size)
        total = int(n_extra.sum())
        row_ids = np.repeat(np.arange(size, dtype=np.int64), n_extra)
        flat_cols = filter_rng.integers(0, size, size=total, dtype=np.int64)
        row_ids = np.concatenate(
            [row_ids, np.arange(size, dtype=np.int64)]
        )
        flat_cols = np.concatenate([flat_cols, ensured.astype(np.int64)])
        key = np.unique(row_ids * np.int64(size) + flat_cols)
        j_counts = np.bincount(key // size, minlength=size)
        solver.extend_from_csr(
            j_counts,
            key % size,
            val_rng.uniform(min_value, max_value, size=key.shape[0]),
        )
        return
    # per-row draws in row order define the instance; one bulk ingest
    keep = filter_rng.random((size, size)) < density
    keep[np.arange(size), ensured] = True
    row_cols = []
    row_vals = []
    for i in range(size):
        cols = np.nonzero(keep[i])[0]
        row_cols.append(cols)
        row_vals.append(
            val_rng.uniform(min_value, max_value, size=cols.shape[0])
        )
    if row_cols:
        solver.extend_from_csr(
            [c.shape[0] for c in row_cols],
            np.concatenate(row_cols),
            np.concatenate(row_vals),
        )


def gen_asymmetric_input(
    solver,
    seed: int,
    num_of_people: int,
    num_of_objects: int,
    arcs_per_person: int,
    min_value: float,
    range_width: float,
) -> None:
    """k-regular sparse instance: ``arcs_per_person`` distinct objects a
    person, Beta(3,3) values scaled to [min_value, min_value +
    range_width) and floored to integers."""
    val_rng = np.random.default_rng(seed)
    filter_rng = np.random.default_rng(seed + 1)

    solver.init(num_of_people, num_of_objects)
    row_cols = []
    row_vals = []
    for _ in range(num_of_people):
        cols = np.sort(
            filter_rng.choice(num_of_objects, size=arcs_per_person,
                              replace=False)
        )
        vals = np.floor(
            range_width * val_rng.beta(3.0, 3.0, size=arcs_per_person)
            + min_value
        )
        row_cols.append(cols)
        row_vals.append(vals)
    if row_cols:
        solver.extend_from_csr(
            np.full(num_of_people, arcs_per_person),
            np.concatenate(row_cols),
            np.concatenate(row_vals),
        )


def gen_ksparse_uniform(
    solver,
    seed: int,
    num_rows: int,
    num_cols: int,
    arcs_per_person: int,
    max_value: float,
) -> None:
    """k-sparse instance with U[0, max_value) values (the reference's
    generic test fixture)."""
    val_rng = np.random.default_rng(seed)
    filter_rng = np.random.default_rng(seed + 1)

    solver.init(num_rows, num_cols)
    row_cols = []
    row_vals = []
    for _ in range(num_rows):
        cols = np.sort(
            filter_rng.choice(num_cols, size=arcs_per_person, replace=False)
        )
        row_cols.append(cols)
        row_vals.append(val_rng.uniform(0.0, max_value, size=arcs_per_person))
    if row_cols:
        solver.extend_from_csr(
            np.full(num_rows, arcs_per_person),
            np.concatenate(row_cols),
            np.concatenate(row_vals),
        )


def dense_cost_matrix(solver, big: float = 1e9,
                      original_units: bool = False) -> np.ndarray:
    """The solver's CSR as a full matrix with ``big`` at missing arcs,
    for oracle (scipy) checks.  ``original_units=True`` undoes the sign
    flip that a solve may have applied to the stored values (the
    ``values[0]`` sign rule of ``get_objective``); the ``big`` fill is
    left as it is."""
    mat = np.full((solver.num_rows, solver.num_cols), big, dtype=np.float64)
    counts = solver.j_counts.astype(np.int64)
    cols = solver.column_indices.astype(np.int64)
    vals = solver.values
    if original_units and vals.size and vals[0] < 0:
        vals = -vals
    rows = np.repeat(np.arange(solver.num_rows, dtype=np.int64), counts)
    mat[rows, cols] = vals
    return mat


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
