"""ForwardAuctionSolver: the eps-scaling forward auction.

The port of the JAX package's ``symmetric.py`` (the reference crate's
``ForwardAuctionSolver``, after the sslap package).  The reference
specifies the Jacobi schedule (every unassigned person bids each round)
and runs it sequentially; the native engine does the same on the host,
and the device engine runs the rounds literally
(``ops/auction.forward_solve_chunked``), with the reference's outer
logic:

- eps-scaling from ``C / 2``: a complete assignment that is not eps-CS
  resets with kept prices and ``eps *= 0.15``;
- asymmetric instances run without eps-scaling from
  ``target_eps - f64::EPSILON``;
- infeasible instances stop at ``max_iterations`` (default 100,000) on
  the native engine; the device engine stops earlier through its
  infeasibility certificate.

Example
-------
>>> from sparse_linear_assignment_tpu_torch import ForwardAuctionSolver
>>> solver, solution = ForwardAuctionSolver.new(10, 10, 100)
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

from .cpu_reference import forward_solve_cpu, get_lib
from .device import resolve_device
from .ops.auction import forward_solve_chunked
from .ops.padded import staged_problem
from .solution import AuctionSolution
from .solver import AuctionSolver

REDUCTION_FACTOR = 0.15
MAX_ITERATIONS = 100_000
_F64_EPSILON = float(np.finfo(np.float64).eps)


class ForwardAuctionSolver(AuctionSolver):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.nits: int = 0  # rounds (the reference counts the same unit)
        self.nreductions: int = 0
        self.optimal_soln_found: bool = False
        self.max_iterations: int = MAX_ITERATIONS

    def solve(
        self,
        solution: AuctionSolution,
        maximize: bool = False,
        eps: Optional[float] = None,
        engine: str = "auto",
        device=None,
    ) -> None:
        """:meth:`solve_with_params` with the defaults."""
        self.solve_with_params(solution, maximize, eps, None, None,
                               engine=engine, device=device)

    def solve_with_params(
        self,
        solution: AuctionSolution,
        maximize: bool = False,
        eps: Optional[float] = None,
        start_eps: Optional[float] = None,
        max_iterations: Optional[int] = None,
        start_prices=None,
        engine: str = "auto",
        device=None,
    ) -> None:
        """Solve with every parameter.

        ``engine``: ``"auto"`` takes the native sequential engine, except
        when ``start_prices`` is given or some row has a single arc: the
        reference bid rule, which the native engine keeps, bids +inf
        there and loops (``docs/PARITY.md``), so such instances take the
        device engine's guarded bid.  ``"native"`` and ``"device"``
        force an engine.  A native engine that does not build raises.
        ``device`` (``None`` means ``"cuda"``, which raises without a
        card) is where the device engine runs; the native engine
        ignores it.

        ``start_prices`` (a device extension) warm-starts the prices,
        e.g. with ``solver.prices`` of an earlier solve of a similar
        instance with the same ``maximize``; on symmetric instances the
        certificate is unaffected, on asymmetric ones they are unsound
        and ignored with a warning."""
        if engine not in ("auto", "native", "device"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "auto":
            engine = ("device" if start_prices is not None
                      or np.min(self.j_counts) < 2 else "native")
        self.max_iterations = (int(max_iterations)
                               if max_iterations is not None
                               else MAX_ITERATIONS)
        if engine == "native":
            get_lib()  # a failed build raises here, naming g++
            sol2, nits, nreductions, optimal = forward_solve_cpu(
                self, maximize, eps, start_eps, self.max_iterations
            )
            solution.person_to_object = sol2.person_to_object
            solution.object_to_person = sol2.object_to_person
            solution.num_unassigned = sol2.num_unassigned
            solution.eps = sol2.eps
            self.nits = nits
            self.nreductions = nreductions
            self.optimal_soln_found = optimal
            return

        self.validate_input()
        dev = resolve_device(device)
        self.init_solve(solution, maximize)

        target_eps = (float(eps) if eps is not None
                      else 1.0 / float(self.num_rows))
        values = self.values  # sign-flipped by init_solve where needed
        c = float(np.abs(values).max()) if values.size else 0.0
        toleration = self.get_toleration(c)

        start_from_optimal_eps = (start_eps is not None
                                  and start_eps < target_eps)
        if self.num_rows != self.num_cols:
            # no eps-scaling on asymmetric instances
            start_from_optimal_eps = True
            eps0 = target_eps - _F64_EPSILON
        else:
            eps0 = float(start_eps) if start_eps is not None else c / 2.0

        problem = staged_problem(self, dev)
        if start_prices is not None:
            start_prices = np.asarray(start_prices, dtype=np.float64)
            if start_prices.shape != (self.num_cols,):
                raise ValueError(
                    f"start_prices must have shape ({self.num_cols},)"
                )
            if self.num_rows != self.num_cols:
                warnings.warn(
                    "start_prices ignored: warm starts are unsound on "
                    "asymmetric instances (running cold; see "
                    "solve_with_params docstring)",
                    stacklevel=2,
                )
                start_prices = None
        (prices, p2o, o2p, num_unassigned, nits, nreductions,
         optimal_found, final_eps) = forward_solve_chunked(
            problem, eps0, target_eps, toleration, start_from_optimal_eps,
            self.max_iterations, start_prices=start_prices,
            value_bound=c,  # arms the infeasibility certificate
            device=dev,
        )
        self.prices = prices.cpu().numpy().astype(np.float64)
        solution.person_to_object = p2o.cpu().numpy()
        solution.object_to_person = o2p.cpu().numpy()
        solution.num_unassigned = int(num_unassigned)
        solution.eps = float(final_eps)
        self.nits = int(nits)
        self.nreductions = int(nreductions)
        self.optimal_soln_found = bool(optimal_found)
