"""Padded dual-layout (CSR and CSC) form of a sparse LAP on a device.

The port of the JAX package's ``ops/padded.py``.  The reference crate
keeps the arcs in a flat CSR triple and scans rows one after another;
the synchronous rounds want fixed shapes instead:

1. **person-major padded CSR, ``[K, N]``**: arc slot ``a`` of person
   ``u`` at ``[a, u]``, so the per-person top-2 is a reduction over the
   small slot axis;
2. **object-major padded CSC, ``[Kc, M]``**: the persons incident to
   each object, so conflict resolution is a gather of each object's
   incident bids and a masked reduction, with no scatter.

Both are built on the host with NumPy once a solve and copied to the
device once; the rounds then only read them.  The ``_t`` transposes
``[N, K]`` serve the slot-list rounds, which gather whole person rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..solution import INDEX_DTYPE

_FIELDS = (
    "row_cols", "row_vals", "row_mask", "col_persons", "col_mask",
    "row_cols_t", "row_vals_t", "row_mask_t",
    "row_cols8", "row_vals8", "row_mask8",
    "ovf_person", "ovf_cols", "ovf_vals", "ovf_mask",
)


class PaddedProblem:
    """Fixed-shape tensors of one LAP instance (or, with a leading batch
    dimension on the first five, of a batch of them).

    - ``row_cols`` int32 ``[K, N]``: column of arc slot a of person u
      (pad 0); ``row_vals`` ``[K, N]`` its value (pad 0, masked);
      ``row_mask`` bool ``[K, N]``: the slot holds an arc;
    - ``col_persons`` int32 ``[Kc, M]``: the persons incident to object
      j (pad 0); ``col_mask`` bool ``[Kc, M]``;
    - ``row_cols_t``/``row_vals_t``/``row_mask_t`` ``[N, K]``: the
      transposes, for the row gathers of the slot-list rounds;
    - the degree split, present when ``k_max > 8`` and some person has
      more than 8 arcs (else ``None``): ``row_cols8``/``row_vals8``/
      ``row_mask8`` ``[8, N]``, the first 8 slots of every person, and
      an overflow block of the arcs beyond 8 of the few persons that
      have them, ``ovf_person [V]`` and ``ovf_cols``/``ovf_vals``/
      ``ovf_mask [k_max - 8, V]``.  Full-scan rounds read about nnz
      slots this way instead of ``k_max * N``; base slots precede
      overflow slots in row order, so the first-maximum tie rule of the
      top-2 merge is kept.
    """

    def __init__(self, row_cols, row_vals, row_mask, col_persons, col_mask,
                 row_cols_t=None, row_vals_t=None, row_mask_t=None,
                 row_cols8=None, row_vals8=None, row_mask8=None,
                 ovf_person=None, ovf_cols=None, ovf_vals=None,
                 ovf_mask=None):
        self.row_cols = row_cols
        self.row_vals = row_vals
        self.row_mask = row_mask
        self.col_persons = col_persons
        self.col_mask = col_mask
        self.row_cols_t = row_cols_t
        self.row_vals_t = row_vals_t
        self.row_mask_t = row_mask_t
        self.row_cols8 = row_cols8
        self.row_vals8 = row_vals8
        self.row_mask8 = row_mask8
        self.ovf_person = ovf_person
        self.ovf_cols = ovf_cols
        self.ovf_vals = ovf_vals
        self.ovf_mask = ovf_mask
        #: captured chunks of rounds on this problem (``ops/graphs.py``)
        self.graphs = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.row_vals.dtype

    @property
    def device(self) -> torch.device:
        return self.row_vals.device

    @property
    def num_rows(self) -> int:
        return self.row_cols.shape[-1]

    @property
    def num_cols(self) -> int:
        return self.col_persons.shape[-1]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_padded_arrays(
    num_rows: int,
    num_cols: int,
    j_counts: np.ndarray,
    column_indices: np.ndarray,
    values: np.ndarray,
    dtype=np.float32,
    k_pad_multiple: int = 1,
) -> dict:
    """The dual padded layout of a host CSR instance as NumPy arrays,
    keyed by :class:`PaddedProblem` field (absent split fields are
    ``None``): the same arrays as the JAX package's
    ``build_padded_problem(..., to_device=False)``."""
    counts = np.asarray(j_counts, dtype=np.int64)
    cols = np.asarray(column_indices, dtype=np.int64)
    vals = np.asarray(values)
    nnz = cols.shape[0]
    if counts.sum() != nnz:
        raise ValueError("j_counts must sum to the number of arcs")

    k_max = int(counts.max()) if counts.size else 1
    k_max = max(1, _round_up(k_max, k_pad_multiple))

    row_of_arc = np.repeat(np.arange(num_rows, dtype=np.int64), counts)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos_in_row = np.arange(nnz, dtype=np.int64) - starts[row_of_arc]

    row_cols = np.zeros((k_max, num_rows), dtype=INDEX_DTYPE)
    row_vals = np.zeros((k_max, num_rows), dtype=dtype)
    row_mask = np.zeros((k_max, num_rows), dtype=bool)
    row_cols[pos_in_row, row_of_arc] = cols
    row_vals[pos_in_row, row_of_arc] = vals.astype(dtype)
    row_mask[pos_in_row, row_of_arc] = True

    # the transposed (object-major) incidence
    in_counts = np.bincount(cols, minlength=num_cols).astype(np.int64)
    kc_max = int(in_counts.max()) if in_counts.size else 1
    kc_max = max(1, _round_up(kc_max, k_pad_multiple))

    order = np.argsort(cols, kind="stable")
    col_sorted = cols[order]
    person_sorted = row_of_arc[order]
    col_starts = np.concatenate([[0], np.cumsum(in_counts)])[:-1]
    pos_in_col = np.arange(nnz, dtype=np.int64) - col_starts[col_sorted]

    col_persons = np.zeros((kc_max, num_cols), dtype=INDEX_DTYPE)
    col_mask = np.zeros((kc_max, num_cols), dtype=bool)
    col_persons[pos_in_col, col_sorted] = person_sorted
    col_mask[pos_in_col, col_sorted] = True

    out = dict.fromkeys(_FIELDS)
    out.update(
        row_cols=row_cols, row_vals=row_vals, row_mask=row_mask,
        col_persons=col_persons, col_mask=col_mask,
        row_cols_t=np.ascontiguousarray(row_cols.T),
        row_vals_t=np.ascontiguousarray(row_vals.T),
        row_mask_t=np.ascontiguousarray(row_mask.T),
    )
    if k_max > 8:
        ovf = np.nonzero(counts > 8)[0]
        if ovf.size:
            out.update(
                row_cols8=row_cols[:8],
                row_vals8=row_vals[:8],
                row_mask8=row_mask[:8],
                ovf_person=ovf.astype(INDEX_DTYPE),
                ovf_cols=np.ascontiguousarray(row_cols[8:, ovf]),
                ovf_vals=np.ascontiguousarray(row_vals[8:, ovf]),
                ovf_mask=np.ascontiguousarray(row_mask[8:, ovf]),
            )
    return out


def padded_problem_from_numpy(fields: dict, device=None) -> PaddedProblem:
    """A :class:`PaddedProblem` on ``device`` from NumPy arrays keyed by
    field name (missing or ``None`` fields stay ``None``): the arrays of
    :func:`build_padded_arrays`, or the JAX package's
    ``PaddedProblem`` fields read back as NumPy.  ``device=None`` means
    ``"cuda"``."""
    dev = resolve_device(device)
    out = {}
    for name in _FIELDS:
        arr = fields.get(name)
        out[name] = (None if arr is None
                     else torch.from_numpy(np.array(arr)).to(dev))
    return PaddedProblem(**out)


def build_padded_problem(
    num_rows: int,
    num_cols: int,
    j_counts: np.ndarray,
    column_indices: np.ndarray,
    values: np.ndarray,
    dtype=np.float32,
    k_pad_multiple: int = 1,
    device=None,
) -> PaddedProblem:
    """Host CSR (the reference's layout) to the dual padded layout on
    ``device`` (``None`` means ``"cuda"``), copied there once."""
    return padded_problem_from_numpy(
        build_padded_arrays(num_rows, num_cols, j_counts, column_indices,
                            values, dtype=dtype,
                            k_pad_multiple=k_pad_multiple),
        device,
    )


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype of a torch value dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def problem_on(problem: PaddedProblem, device: Optional[object]):
    """Resolve ``device`` (``None`` means ``"cuda"``) and check that
    ``problem`` lies there: a solve never moves quietly off the device
    its caller named."""
    dev = resolve_device(device)
    have = problem.device
    if have.type != dev.type or (
        dev.index is not None and have.index != dev.index
    ):
        raise ValueError(
            f"the problem lies on {have}, but device={dev} was asked for"
        )
    return have


def staged_problem(solver, dev) -> PaddedProblem:
    """An ``AuctionSolver``'s padded problem on ``dev``, built once for
    each CSR state: repeated solves of an unchanged instance reuse it.  The key
    is ``_csr_version`` (every builder mutation and the maximize
    re-flip bump it), the value dtype, the shape and the device, so a
    solve on the CPU after one on the card never reuses card tensors."""
    meta = (np.dtype(solver.dtype), solver.num_rows, solver.num_cols,
            str(dev))
    staged = getattr(solver, "_staged_problem", None)
    if staged is not None and staged[0] == solver._csr_version \
            and staged[1] == meta:
        return staged[2]
    problem = build_padded_problem(
        solver.num_rows, solver.num_cols, solver.j_counts,
        solver.column_indices, solver.values, dtype=solver.dtype,
        device=dev,
    )
    solver._staged_problem = (solver._csr_version, meta, problem)
    return problem
