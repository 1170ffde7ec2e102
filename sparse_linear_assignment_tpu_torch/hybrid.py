"""Device bulk rounds plus native chain tails: the hybrid Khosla solve.

The port of the JAX package's ``hybrid.py``.  An auction solve has two
regimes:

- **bulk rounds**: thousands of unassigned persons bid at once, a good
  fit for the device (one full-scan round assigns most of them);
- **chain tails**: the endgame is displacement chains, person A takes
  B's object, B takes C's, strictly one step after another; the native
  C++ engine steps them far faster than a device round trip.

Each eps-scaling phase runs its bulk on the device (``ops/compact.py``'s
full-scan rounds) and hands the warm state (prices and the partial
assignment) to the native engine (``native/engine.cpp``'s
``slap_khosla_finish``) to finish the phase.  Both engines apply the
same choice, update and drop rules, so the final matching carries the
same eps-optimality certificate as either alone.  With no device phase
(``tpu_phases=0``, ``problem=None``) this is the native eps-scaling
ladder, ``KhoslaSolver``'s route for large symmetric instances.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cpu_reference import khosla_finish_cpu
from .ops.compact import LState, fresh_lstate, khosla_full_chunk
from .ops.padded import PaddedProblem, numpy_dtype, problem_on
from .solution import UNASSIGNED
from .utils.trace import trace_host

_INT_MAX = np.int32(UNASSIGNED)


def _read_lstate(state: LState):
    """The phase's device state in the native engine's conventions: -1
    sentinels, uint8 ``dropped``, float64 prices (float32 widens
    exactly).  Four small copies to the host after one synchronise."""
    p2o = state.p2o.cpu().numpy()
    o2p = state.o2p.cpu().numpy()
    dropped = state.dropped.cpu().numpy().astype(np.uint8)
    prices64 = state.prices.cpu().numpy().astype(np.float64)
    p2o = np.where(p2o == _INT_MAX, -1, p2o).astype(np.int32)
    o2p = np.where(o2p == _INT_MAX, -1, o2p).astype(np.int32)
    return p2o, o2p, dropped, np.ascontiguousarray(prices64)


def khosla_solve_hybrid(
    num_rows: int,
    num_cols: int,
    csr_starts: np.ndarray,
    csr_cols: np.ndarray,
    csr_vals: np.ndarray,
    problem: Optional[PaddedProblem],
    eps_target: float,
    w_min: float,
    w_max: float,
    scale: bool = True,
    reduction_factor: float = 0.03,
    tail_threshold: int = 65536,
    chunk: int = 4,
    start_prices=None,
    tpu_phases: Optional[int] = 1,
    threshold_pad: float = 0.0,
    device=None,
):
    """Solve with device bulk rounds and native chain tails.

    The eps ladder (symmetric instances with ``scale``) starts at
    ``(w_max - w_min) / 4`` and falls by ``reduction_factor``; every
    phase completes (bulk and tail) before the next.  A phase runs its
    bulk on the device when it is one of the first ``tpu_phases``
    (``None``: all) and more than ``tail_threshold`` persons are
    unassigned: ``chunk`` full-scan rounds with no polling, one
    readback, then the native engine finishes the phase.  Each phase's
    drop threshold is shifted by its start price level, as in
    ``ops/compact.py:khosla_solve_scaled``.

    ``device`` (``None`` means ``"cuda"``) is where the bulk rounds run
    and where ``problem`` must lie; it is checked whenever a problem is
    given and ``tpu_phases`` is not 0, also if no phase turns out to
    need the device.  ``tpu_phases=0`` (``problem`` may be ``None``) is
    the pure native ladder.  ``start_prices`` warm-starts
    the prices.  Returns ``(prices64, p2o, o2p, dropped, device_rounds,
    native_pops)`` with ``UNASSIGNED`` in the assignment arrays."""
    n, m = num_rows, num_cols
    span = w_max - w_min
    np_dtype = (numpy_dtype(problem.dtype) if problem is not None
                else np.dtype(np.float32))

    if scale and n == m:
        eps = max(span / 4.0, eps_target)
    else:
        eps = eps_target
    ladder = []
    while eps > eps_target:
        ladder.append(eps)
        eps *= reduction_factor
    ladder.append(eps_target)

    # host state in the native engine's convention (-1 = unassigned)
    prices64 = (np.zeros(m, dtype=np.float64) if start_prices is None
                else np.array(start_prices, dtype=np.float64))
    p2o = np.full(n, -1, dtype=np.int32)
    o2p = np.full(m, -1, dtype=np.int32)
    dropped = np.zeros(n, dtype=np.uint8)

    device_rounds = 0
    native_pops = 0
    dev = None
    if problem is not None and tpu_phases != 0:
        dev = problem_on(problem, device)
    for phase_i, phase_eps in enumerate(ladder):
        pad = threshold_pad if phase_i == 0 else max(
            0.0, float(prices64.max()))
        threshold = (m / 2.0) * (span + phase_eps) + pad
        if phase_i > 0:
            # a new phase keeps the prices and resets the assignment
            p2o.fill(-1)
            o2p.fill(-1)
            dropped.fill(0)

        unassigned = int((p2o < 0).sum())
        on_device = tpu_phases is None or phase_i < tpu_phases
        if on_device and unassigned > tail_threshold:
            if problem is None:
                raise ValueError(
                    "device bulk phases need a padded problem "
                    "(problem=None runs with tpu_phases=0 only)"
                )
            # only the warm prices cross; the reset assignment is made
            # on the device
            state = fresh_lstate(
                torch.from_numpy(prices64.astype(np_dtype)).to(dev), n)
            state, _ = khosla_full_chunk(
                problem, state, np_dtype.type(phase_eps),
                np_dtype.type(threshold), chunk)
            device_rounds += chunk
            p2o, o2p, dropped, prices64 = _read_lstate(state)
            trace_host(
                "hybrid phase {}: eps={} bulk rounds={} unassigned={}",
                phase_i, phase_eps, chunk, int((p2o < 0).sum()),
            )

        # the native chain tail: the phase's exact sequential finish
        phase_pops = khosla_finish_cpu(
            n, m, csr_starts, csr_cols, csr_vals,
            phase_eps, threshold, p2o, o2p, prices64, dropped,
        )
        native_pops += phase_pops
        trace_host(
            "hybrid phase {}: eps={} native pops={} unassigned={}",
            phase_i, phase_eps, phase_pops, int((p2o < 0).sum()),
        )

    p2o_out = np.where(p2o < 0, _INT_MAX, p2o).astype(np.int32)
    o2p_out = np.where(o2p < 0, _INT_MAX, o2p).astype(np.int32)
    return prices64, p2o_out, o2p_out, dropped, device_rounds, native_pops
