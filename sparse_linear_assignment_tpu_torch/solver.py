"""Base auction solver: CSR construction, lifecycle, validation, evaluators.

The reference crate's ``AuctionSolver`` trait with its default methods,
as in the JAX package's ``solver.py`` (NumPy only; the port keeps its
own copy).  The CSR triple (row offsets, per-row counts, column indices,
values) is built on the host with the reference's validation contract:
rows arrive in nondecreasing order, a row must be nonempty before the
next one starts, ``num_rows <= num_cols``.  The evaluators
(``get_objective``, ``get_toleration``, ``ecs_satisfied``) are
vectorised NumPy forms of the reference's sequential loops; the device
forms used inside the solve loops are ``ops/auction.py``'s
``ecs_margins`` and ``ecs_satisfied_device``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .solution import INDEX_DTYPE, UNASSIGNED, AuctionSolution


class AuctionSolver:
    """Shared base of :class:`KhoslaSolver` and
    :class:`ForwardAuctionSolver`: ``num_rows``/``num_cols``,
    ``prices`` and the CSR triple ``i_starts_stops``/``j_counts``/
    ``column_indices``/``values``."""

    #: dtype of prices and values in the device rounds: float64 keeps
    #: the reference's f64 contract, float32 is the fast path
    dtype = np.float64

    def __init__(
        self,
        row_capacity: int = 0,
        column_capacity: int = 0,
        arcs_capacity: int = 0,
        dtype=np.float64,
    ):
        self.row_capacity = int(row_capacity)
        self.column_capacity = int(column_capacity)
        self.arcs_capacity = int(arcs_capacity)
        self.dtype = np.dtype(dtype)

        self.num_rows: int = 0
        self.num_cols: int = 0
        self.prices: np.ndarray = np.zeros(0, dtype=np.float64)

        # CSR storage preallocated at the capacity hints, so rebuilding
        # an instance at capacity never reallocates.  `_narcs` and
        # `_nrows_built` are the live prefixes; the arrays double when a
        # hint is exceeded.  Sign flips happen in place; `_csr_version`
        # bumps on every mutation so the staged-problem caches key on it
        # instead of on array identity.
        self._iss = np.zeros(max(self.row_capacity, 1) + 1, dtype=np.int64)
        self._jc = np.zeros(max(self.row_capacity, 1), dtype=np.int64)
        self._cols = np.empty(max(self.arcs_capacity, 0), dtype=INDEX_DTYPE)
        self._vals = np.empty(max(self.arcs_capacity, 0), dtype=np.float64)
        self._nrows_built = 1  # len(j_counts); the reference seeds [0]
        self._narcs = 0
        self._csr_version = 0

    @classmethod
    def new(
        cls,
        row_capacity: int,
        column_capacity: int,
        arcs_capacity: int,
        dtype=np.float64,
    ):
        """``(solver, solution)``, the reference's ``new``."""
        solver = cls(row_capacity, column_capacity, arcs_capacity,
                     dtype=dtype)
        return solver, AuctionSolution.new(row_capacity, column_capacity)

    # ------------------------------------------------------------------
    # CSR builder
    # ------------------------------------------------------------------
    def init(self, num_rows: int, num_cols: int) -> None:
        """Reset the CSR storage for a new problem."""
        if not num_rows <= num_cols:
            raise ValueError(
                f"num_rows ({num_rows}) must be <= num_cols ({num_cols})"
            )
        if not num_rows < UNASSIGNED:
            raise ValueError("num_rows must be < the UNASSIGNED sentinel")
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        # the reference pre-seeds i_starts_stops=[0, 0], j_counts=[0];
        # only the live prefixes reset, the capacity-sized arrays stay
        self._iss[0] = 0
        self._iss[1] = 0
        self._jc[0] = 0
        self._nrows_built = 1
        self._narcs = 0
        self._csr_version += 1

    def _grow_arcs(self, extra: int) -> None:
        need = self._narcs + extra
        cap = self._cols.shape[0]
        if need > cap:
            new_cap = max(need, 2 * cap, 16)
            cols = np.empty(new_cap, dtype=INDEX_DTYPE)
            vals = np.empty(new_cap, dtype=np.float64)
            cols[: self._narcs] = self._cols[: self._narcs]
            vals[: self._narcs] = self._vals[: self._narcs]
            self._cols = cols
            self._vals = vals

    def _grow_rows(self, extra: int) -> None:
        need = self._nrows_built + extra
        if need > self._jc.shape[0]:
            new_cap = max(need, 2 * self._jc.shape[0], 16)
            jc = np.zeros(new_cap, dtype=np.int64)
            iss = np.zeros(new_cap + 1, dtype=np.int64)
            jc[: self._nrows_built] = self._jc[: self._nrows_built]
            iss[: self._nrows_built + 1] = self._iss[: self._nrows_built + 1]
            self._jc = jc
            self._iss = iss

    def _open_row(self, row: int, length: int) -> None:
        """Account ``length`` arcs to ``row``, which must be the current
        row or the next one (the current one then must be nonempty)."""
        current_row = self._nrows_built - 1
        if row != current_row and row != current_row + 1:
            raise ValueError(
                f"row {row} out of order (current row {current_row})"
            )
        cumulative_offset = int(self._iss[current_row + 1]) + length
        if row > current_row:
            if not self._jc[current_row] > 0:
                raise ValueError(f"row {current_row} has no arcs")
            self._grow_rows(1)
            self._nrows_built += 1
            self._iss[self._nrows_built] = cumulative_offset
            self._jc[self._nrows_built - 1] = length
        else:
            self._iss[current_row + 1] = cumulative_offset
            self._jc[current_row] += length

    def add_value(self, row: int, column: int, value: float) -> None:
        """Append one arc; rows arrive in nondecreasing order."""
        self._open_row(row, 1)
        self._grow_arcs(1)
        self._cols[self._narcs] = int(column)
        self._vals[self._narcs] = float(value)
        self._narcs += 1
        self._csr_version += 1

    def extend_from_values(
        self, row: int, columns: Sequence[int], values: Sequence[float]
    ) -> None:
        """Append a whole row's arcs at once."""
        columns = np.asarray(columns)
        values = np.asarray(values, dtype=np.float64)
        if len(columns) != len(values):
            raise ValueError("columns and values must have the same length")
        current_row = self._nrows_built - 1
        if row != current_row and row != current_row + 1:
            raise ValueError(
                f"row {row} out of order (current row {current_row})"
            )
        if columns.size and np.issubdtype(columns.dtype, np.number):
            cmin, cmax = columns.min(), columns.max()
            if not (-(2 ** 31) <= int(cmin) and int(cmax) < 2 ** 31):
                # would wrap in the int32 store and could then pass
                # validate_input's range check
                raise ValueError("column index out of int32 range")
        length = len(columns)
        self._open_row(row, length)
        self._grow_arcs(length)
        self._cols[self._narcs: self._narcs + length] = columns
        self._vals[self._narcs: self._narcs + length] = values
        self._narcs += length
        self._csr_version += 1

    def extend_from_csr(self, j_counts, column_indices, values) -> None:
        """Append whole rows from CSR arrays: the same result as one
        :meth:`extend_from_values` a row (rows in order, every row
        nonempty), vectorised for large ingests.  ``j_counts[r]`` is row
        r's arc count; ``column_indices``/``values`` hold all rows' arcs
        concatenated in row order.  The rows continue after any rows
        already built; the current row must be nonempty first."""
        j_counts = np.asarray(j_counts, dtype=np.int64)
        columns = np.asarray(column_indices)
        values = np.asarray(values, dtype=np.float64)
        if j_counts.ndim != 1 or columns.ndim != 1 or values.ndim != 1:
            raise ValueError("extend_from_csr expects 1-D arrays")
        if len(columns) != len(values):
            raise ValueError("columns and values must have the same length")
        if j_counts.size == 0:
            if len(columns):
                raise ValueError("j_counts must sum to len(values)")
            return
        if int(j_counts.min()) <= 0:
            raise ValueError(
                f"row {int(np.argmin(j_counts))} of the appended block "
                "has no arcs"
            )
        if int(j_counts.sum()) != len(values):
            raise ValueError("j_counts must sum to len(values)")
        if not np.issubdtype(columns.dtype, np.integer):
            cols64 = columns.astype(np.int64)
            if not np.array_equal(cols64, columns):
                raise ValueError("column indices must be integers")
            columns = cols64
        if columns.size and not (
            -(2 ** 31) <= int(columns.min())
            and int(columns.max()) < 2 ** 31
        ):
            raise ValueError("column index out of int32 range")
        current_row = self._nrows_built - 1
        fresh = current_row == 0 and self._jc[0] == 0
        if not fresh and self._jc[current_row] == 0:
            raise ValueError(f"row {current_row} has no arcs")
        base = int(self._iss[self._nrows_built])
        k = int(j_counts.shape[0])
        if fresh:
            # the pre-seed is [0, 0] / [0]: the first appended row IS
            # row 0 (the state extend_from_values reaches)
            self._grow_rows(k - 1)
            self._jc[:k] = j_counts
            self._iss[0] = 0
            np.cumsum(j_counts, out=self._iss[1: k + 1])
            self._nrows_built = k
        else:
            self._grow_rows(k)
            start = self._nrows_built
            self._jc[start: start + k] = j_counts
            self._iss[start + 1: start + 1 + k] = base + np.cumsum(j_counts)
            self._nrows_built = start + k
        self._grow_arcs(len(values))
        self._cols[self._narcs: self._narcs + len(values)] = columns
        self._vals[self._narcs: self._narcs + len(values)] = values
        self._narcs += len(values)
        self._csr_version += 1

    def extend_from_scipy_csr(self, matrix) -> None:
        """Append a ``scipy.sparse`` matrix's rows as arcs: one arc for
        every stored entry (a stored zero is a legal arc value).  Every
        row must store at least one entry."""
        csr = matrix.tocsr()
        self.extend_from_csr(np.diff(csr.indptr), csr.indices, csr.data)

    def num_of_arcs(self) -> int:
        return self._narcs

    # Read-only views of the CSR state: the staged-problem caches key on
    # `_csr_version`, so an untracked edit in place would leave a stale
    # staged problem.  Mutate through the builder or `map_values`.
    @staticmethod
    def _ro(view: np.ndarray) -> np.ndarray:
        view.flags.writeable = False  # the view only; storage stays
        return view

    @property
    def i_starts_stops(self) -> np.ndarray:
        return self._ro(self._iss[: self._nrows_built + 1])

    @property
    def j_counts(self) -> np.ndarray:
        return self._ro(self._jc[: self._nrows_built])

    @property
    def column_indices(self) -> np.ndarray:
        return self._ro(self._cols[: self._narcs])

    @property
    def values(self) -> np.ndarray:
        return self._ro(self._vals[: self._narcs])

    def map_values(self, func) -> None:
        """Apply ``func`` to the stored arc values in place (e.g.
        ``solver.map_values(np.floor)``) and invalidate any staged
        problem.  ``func`` may mutate its argument and return None, or
        return an array of the same shape."""
        vals = self._vals[: self._narcs]
        out = func(vals)
        if out is not None and out is not vals:
            out = np.asarray(out)
            if out.shape != vals.shape:
                raise ValueError(
                    f"map_values func returned shape {out.shape}, "
                    f"expected {vals.shape} (or None for in-place)"
                )
            vals[:] = out
        self._csr_version += 1

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def validate_input(self) -> None:
        """Checks before a solve."""
        arcs_count = self.num_of_arcs()
        if not arcs_count > 0:
            raise ValueError("no arcs")
        if not (self.num_rows > 0 and self.num_cols > 0):
            raise ValueError("empty problem")
        if not arcs_count < UNASSIGNED:
            raise ValueError("too many arcs for int32 indexing")
        cols = self.column_indices
        if cols.size and int(cols.max()) >= self.num_cols:
            raise ValueError("column index out of range")

    def init_solve(self, solution: AuctionSolution, maximize: bool) -> None:
        """Reset the per-solve state and flip the stored values' sign in
        place when ``maximize ^ (values[0] >= 0)``, as the reference
        does: a minimisation runs as a max-profit auction on negated
        values, and solving twice flips back."""
        vals = self._vals[: self._narcs]
        positive_values = bool(vals[0] >= 0.0) if vals.size else True
        if maximize ^ positive_values:
            np.negative(vals, out=vals)
            self._csr_version += 1

        # new arrays, not refills: callers hold solver.prices and the
        # solution's arrays across solves (warm starts pass the prices
        # back in)
        self.prices = np.zeros(self.num_cols, dtype=np.float64)
        solution.person_to_object = np.full(
            self.num_rows, UNASSIGNED, dtype=INDEX_DTYPE
        )
        solution.object_to_person = np.full(
            self.num_cols, UNASSIGNED, dtype=INDEX_DTYPE
        )
        solution.num_unassigned = self.num_rows

    # ------------------------------------------------------------------
    # Evaluators
    # ------------------------------------------------------------------
    def _row_of_arc(self) -> np.ndarray:
        counts = self.j_counts.astype(np.int64)
        return np.repeat(np.arange(len(counts), dtype=np.int64), counts)

    def get_objective(self, solution: AuctionSolution) -> float:
        """Objective of the assignment in the caller's cost units: the
        stored values may have been negated by ``init_solve``, and the
        reference's ``values[0]`` sign rule undoes it."""
        vals = self.values
        cols = self.column_indices
        if vals.size == 0:
            return 0.0
        positive_values = bool(vals[0] >= 0.0)
        p2o = np.asarray(solution.person_to_object)
        # each arc's column against its row's chosen object; unassigned
        # rows (the sentinel) never match
        chosen = p2o[self._row_of_arc()].astype(np.int64)
        obj = float(vals[cols.astype(np.int64) == chosen].sum())
        return obj if positive_values else -obj

    def get_toleration(self, max_abs_cost: float) -> float:
        """Float tolerance of the eps-CS certificate: one ulp-style bound
        at the magnitude of the largest cost.  The reference truncates
        log2 toward zero and saturates negatives at 0."""
        exp = max(0, int(np.log2(max_abs_cost + 1e-7)))
        return float(2.0 ** (exp - 53))

    def ecs_satisfied(
        self, person_to_object: np.ndarray, eps: float, toleration: float
    ) -> bool:
        """eps-complementary slackness: for every person i with chosen
        object j, ``max_k (a_ik - p_k) - eps <= a_ij - p_j + tol``.
        ``person_to_object`` must be a full assignment (the certificate
        is undefined for a partial one), else ``ValueError``."""
        vals = self.values
        cols = self.column_indices.astype(np.int64)
        nrows = len(self.j_counts)
        prices = self.prices
        p2o = np.asarray(person_to_object).astype(np.int64)
        if np.any(p2o >= len(prices)):
            raise ValueError(
                "ecs_satisfied requires a full assignment: "
                f"{int(np.sum(p2o >= len(prices)))} persons are "
                "unassigned (the certificate is undefined for partial "
                "matchings)"
            )

        row_of_arc = self._row_of_arc()
        profit = vals - prices[cols]
        is_chosen = cols == p2o[row_of_arc]
        # chosen value per row (-inf when the chosen object is not among
        # the row's arcs, the reference's default)
        chosen_value = np.full(nrows, -np.inf)
        np.maximum.at(chosen_value, row_of_arc[is_chosen], vals[is_chosen])
        lhs = chosen_value - prices[p2o] + toleration
        max_profit = np.full(nrows, -np.inf)
        np.maximum.at(max_profit, row_of_arc, profit)
        return bool(np.all(lhs >= max_profit - eps))
