"""KhoslaSolver: the auction for asymmetric k-regular sparse LAPs.

The port of the JAX package's ``ksparse.py`` (the reference crate's
``KhoslaSolver``, the algorithm of arXiv:2101.07155).  The reference
runs a sequential LIFO stack of bidders; the native engine here does
the same on the host, and the device engines run synchronous rounds in
which every unassigned person bids (``ops/auction.py``, the slot-list
engine of ``ops/compact.py``, the hybrid of ``hybrid.py``).  The
auction is order-insensitive up to tie-breaking, so the eps-optimality
and finite-termination guarantees carry over; on instances with several
optima the matching found may differ from the crate's.

Example
-------
>>> from sparse_linear_assignment_tpu_torch import KhoslaSolver
>>> solver, solution = KhoslaSolver.new(10, 10, 100)
>>> weights = [[10, 6, 14, 1], [17, 18, 16]]
>>> solver.init(2, 4)
>>> for i, row in enumerate(weights):
...     solver.extend_from_values(i, range(len(row)), row)
>>> solver.solve(solution, maximize=False)
>>> assert solution.num_unassigned == 0
>>> assert solver.get_objective(solution) == 1.0 + 16.0
>>> assert list(solution.person_to_object) == [3, 2]
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from .cpu_reference import get_lib, khosla_solve_cpu
from .device import resolve_device
from .ops.auction import khosla_solve
from .ops.compact import fresh_lstate, khosla_solve_compact, \
    khosla_solve_scaled
from .ops.padded import staged_problem
from .solution import UNASSIGNED, AuctionSolution
from .solver import AuctionSolver


def _csr_starts(counts) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return starts


class KhoslaSolver(AuctionSolver):
    """Auction solver with the price-threshold drop rule, which ends in
    finitely many steps even without a perfect matching."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: the last solve's work: stack pops on the native engine (the
        #: reference's unit), rounds on the device engines, rounds plus
        #: pops on the hybrid and the native ladder
        self.nits: int = 0

    #: above this many rows the device engine's default is the
    #: slot-list engine (on the card it always is)
    COMPACT_THRESHOLD = 8192

    #: symmetric instances with at least this many rows take the native
    #: eps-scaling ladder on the auto route
    NATIVE_LADDER_THRESHOLD = 4096

    def solve(
        self,
        solution: AuctionSolution,
        maximize: bool = False,
        eps: Optional[float] = None,
        max_rounds: int = 10_000_000,
        scale_eps: bool = False,
        compact: Optional[bool] = None,
        hybrid: bool = False,
        start_prices=None,
        engine: str = "auto",
        device=None,
    ) -> None:
        """Solve the current instance.  ``eps`` defaults to
        ``1 / num_cols``.

        ``engine``:

        - ``"auto"``: the native sequential engine (the reference's own
          semantics), with the native eps-scaling ladder from
          ``NATIVE_LADDER_THRESHOLD`` symmetric rows; the device engines
          when ``scale_eps``, ``compact``, ``hybrid`` or
          ``start_prices`` is given (they parameterise them);
        - ``"native"``: the native engine;
        - ``"device"``: the device engines.

        A native engine that does not build raises; no route switches
        engines.  ``device`` (``None`` means ``"cuda"``, which raises
        without a card) is where the device engines run; the native
        engine ignores it.

        Device extensions over the reference:

        - ``max_rounds``: a cutoff for float32, where ``price + eps``
          can round to ``price``;
        - ``scale_eps``: an eps-scaling ladder down to ``eps`` (the same
          certificate, far fewer bids on large instances);
        - ``compact``: the slot-list engine; by default on when the
          instance has more than ``COMPACT_THRESHOLD`` rows, with
          ``scale_eps``, or on a CUDA device; otherwise the CPU runs the
          whole-instance rounds of ``ops/auction.khosla_solve``;
        - ``hybrid``: device bulk rounds and native chain tails
          (``hybrid.py``); with ``scale_eps=True`` for large symmetric
          instances;
        - ``start_prices``: warm-start the prices, e.g. with
          ``solver.prices`` of an earlier solve of a similar instance
          with the same ``maximize``.  Sound on symmetric instances; on
          asymmetric ones stale prices on unused objects break the
          n-eps bound, so they are ignored with a warning (the reason
          the reference disables eps-scaling there)."""
        if engine not in ("auto", "native", "device"):
            raise ValueError(f"unknown engine {engine!r}")
        forced_device = (
            scale_eps or hybrid or compact is not None
            or start_prices is not None
        )
        if engine == "auto":
            engine = "device" if forced_device else "native"
        if engine == "native":
            get_lib()  # a failed build raises here, naming g++
            if (self.num_rows == self.num_cols
                    and self.num_rows >= self.NATIVE_LADDER_THRESHOLD):
                self._solve_native_ladder(solution, maximize, eps)
            else:
                sol2, nits = khosla_solve_cpu(self, maximize, eps)
                solution.person_to_object = sol2.person_to_object
                solution.object_to_person = sol2.object_to_person
                solution.num_unassigned = sol2.num_unassigned
                solution.eps = sol2.eps
                self.nits = nits
            return

        self.validate_input()
        dev = resolve_device(device)
        self.init_solve(solution, maximize)

        num_cols_f = float(self.num_cols)
        eps = float(eps) if eps is not None else 1.0 / num_cols_f
        solution.eps = eps

        values = self.values  # sign-flipped by init_solve where needed
        w_min = float(values.min())
        w_max = float(values.max())
        # the finite-termination threshold
        price_threshold = (num_cols_f / 2.0) * (w_max - w_min + eps)

        problem = staged_problem(self, dev)
        if compact is None:
            compact = (self.num_rows > self.COMPACT_THRESHOLD or scale_eps
                       or dev.type == "cuda")
        if start_prices is not None:
            start_prices = np.asarray(start_prices, dtype=np.float64)
            if start_prices.shape != (self.num_cols,):
                raise ValueError(
                    f"start_prices must have shape ({self.num_cols},)"
                )
            if self.num_rows != self.num_cols:
                # an eps-CS matching is n-eps-optimal only when every
                # matching uses the same object set: with spare objects,
                # stale high prices steer the auction away from objects
                # the previous matching used and the certificate cannot
                # see it
                warnings.warn(
                    "start_prices ignored: warm starts are unsound on "
                    "asymmetric instances (running cold; see "
                    "KhoslaSolver.solve docstring)",
                    stacklevel=2,
                )
                start_prices = None
            else:
                compact = compact or not hybrid  # khosla_solve starts cold
                # subtracting a constant from every price changes no
                # choice, bid or certificate; normalise to min 0 so an
                # inflated level from an eps-scaled solve does not trip
                # the cold-start drop threshold
                start_prices = start_prices - float(start_prices.min())
                # the residual spread extends the threshold, so a warm
                # start never drops a person a cold start would assign
                price_threshold += float(start_prices.max())
        warm_pad = 0.0 if start_prices is None else float(start_prices.max())

        if hybrid:
            from .hybrid import khosla_solve_hybrid

            prices, p2o, o2p, _, rounds, pops = khosla_solve_hybrid(
                self.num_rows, self.num_cols, _csr_starts(self.j_counts),
                self.column_indices, values, problem,
                eps, w_min, w_max, scale=scale_eps,
                start_prices=start_prices, threshold_pad=warm_pad,
                device=dev,
            )
            self.prices = prices
            solution.person_to_object = p2o
            solution.object_to_person = o2p
            solution.num_unassigned = int((p2o == UNASSIGNED).sum())
            self.nits = int(rounds + pops)
            return
        if scale_eps:
            state, nits = khosla_solve_scaled(
                problem, eps, w_min, w_max, max_rounds=max_rounds,
                start_prices=start_prices, threshold_pad=warm_pad,
                device=dev,
            )
            prices, p2o, o2p = state.prices, state.p2o, state.o2p
        elif compact:
            init_state = None
            if start_prices is not None:
                init_state = fresh_lstate(
                    problem.row_vals.new_tensor(
                        start_prices.astype(np.dtype(self.dtype))),
                    self.num_rows,
                )
            state = khosla_solve_compact(
                problem, eps, price_threshold, max_rounds=max_rounds,
                init_state=init_state, device=dev,
            )
            prices, p2o, o2p, nits = (state.prices, state.p2o, state.o2p,
                                      int(state.nits))
        else:
            prices, p2o, o2p, _, nits = khosla_solve(
                problem, eps, price_threshold, max_rounds=max_rounds
            )
            nits = int(nits)
        p2o = p2o.cpu().numpy()
        self.prices = prices.cpu().numpy().astype(np.float64)
        solution.person_to_object = p2o
        solution.object_to_person = o2p.cpu().numpy()
        solution.num_unassigned = int((p2o == UNASSIGNED).sum())
        self.nits = nits

    def _solve_native_ladder(
        self,
        solution: AuctionSolution,
        maximize: bool,
        eps: Optional[float],
    ) -> None:
        """The native eps-scaling ladder (the hybrid driver with no
        device phase): the same final eps-CS certificate as a direct
        solve at ``eps``."""
        from .hybrid import khosla_solve_hybrid

        self.validate_input()
        self.init_solve(solution, maximize)
        eps_val = (float(eps) if eps is not None
                   else 1.0 / float(self.num_cols))
        solution.eps = eps_val
        values = self.values
        prices, p2o, o2p, _, rounds, pops = khosla_solve_hybrid(
            self.num_rows, self.num_cols, _csr_starts(self.j_counts),
            self.column_indices, values, None,
            eps_val, float(values.min()), float(values.max()),
            scale=True, tpu_phases=0,
        )
        self.prices = prices
        solution.person_to_object = p2o
        solution.object_to_person = o2p
        solution.num_unassigned = int((p2o == UNASSIGNED).sum())
        self.nits = int(rounds + pops)
