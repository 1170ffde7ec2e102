"""The in-kernel round trace of ``fr_kernel``, ``fr_big_kernel`` and
``ksp_kernel``.

The JAX package's three round kernels print their state once a round
from inside the kernel when tracing is enabled (``SLAP_TPU_DEBUG`` or
``utils.trace.set_debug(True)``).  Here each CUDA kernel takes a log
pointer, null by default; a log selects kernel instances compiled with
the trace (the production ones hold no trace code), in which one thread
an instance writes one int32 row a round into ``[B, rounds, W]``, after
the round's control step:
``FR_FIELDS`` for the FR kernels, ``KSP_FIELDS`` for the Khosla kernel.
After the launch the wrapper copies the log back and prints each
instance's rows in instance order, as many as the rounds it ran (the
change in its ``nits``), through :func:`~..utils.trace.trace_kernel_round`
with JAX's format strings.  The plain versions build and print the
same rows, and every wrapper also returns them through ``trace_rows=``
(zero where an instance ran no round).  With tracing off and no
``trace_rows`` nothing is allocated, copied or printed.

Size.  At the north-star budget (``batch._fr_fused_schedule``: 3,520
rounds at 256²) the log of 4096 instances is 4096 x 3,520 x 16 B =
220 MiB; at 1024², the fused route's largest side, 14,080 rounds make
880 MiB.  A longer log than ``MAX_LOG_BYTES`` is written in pieces of
rounds, one launch each: a launch carries its whole state over, so the
pieces give the same rows and state as one launch.  The big single's
log is 16 B a round of one instance, the Khosla kernel's 12 B a round
of each instance (3 MiB at 4096 instances and its 64-round budget).
"""

from __future__ import annotations

import torch

from ..utils.trace import is_enabled, trace_kernel_round

#: the FR kernels' row: rounds run so far, forward mode, matching
#: cardinality, done (all after the round, as JAX prints them)
FR_FIELDS = ("nits", "mode", "card", "done")

#: the Khosla kernel's row: rounds run so far, whether a person is still
#: active (0 or 1, JAX's ``max`` over the persons), done
KSP_FIELDS = ("nits", "active", "done")

#: JAX's format strings, letter for letter; in the batched FR kernel's
#: line ``g`` is the instance's index in the batch (the port has no
#: grid-step groups)
FR_FORMAT = "fr kernel g=%d round: nits={} mode={} card={} done={}"
FR_BIG_FORMAT = "fr big kernel round: nits={} mode={} card={} done={}"
KSP_FORMAT = "ksp kernel round: nits={} active={} done={}"

#: the most bytes of log one launch writes
MAX_LOG_BYTES = 1 << 30


def check_rows(trace_rows, b: int, rounds: int, width: int, device) -> None:
    """Raise unless ``trace_rows`` is None or a contiguous int32
    ``[b, rounds, width]`` tensor on ``device``."""
    if trace_rows is not None and (
        trace_rows.dtype != torch.int32
        or tuple(trace_rows.shape) != (b, rounds, width)
        or trace_rows.device != device or not trace_rows.is_contiguous()
    ):
        raise ValueError(f"trace_rows must be a contiguous int32 "
                         f"[{b}, {rounds}, {width}] tensor on the values' "
                         f"device")


def emit(fmt: str, pieces) -> None:
    """Print the logged rows: ``pieces`` is a list of ``(rows [B, R, W],
    counts [B])``, one a launch, in order; instance ``i`` prints the
    first ``counts[i]`` rows of each piece in turn.  ``fmt`` may hold
    one ``%d``, the instance's index."""
    host = []
    for rows, counts in pieces:
        counts = counts.cpu().numpy()
        ran = int(counts.max()) if counts.size else 0
        host.append((rows[:, :ran].cpu().numpy(), counts))
    b = len(host[0][1]) if host else 0
    for i in range(b):
        line = fmt % i if "%d" in fmt else fmt
        for rows, counts in host:
            for row in rows[i, :counts[i]].tolist():
                trace_kernel_round(line, *row)


def run_logged(launch, state, rounds: int, b: int, width: int, device,
               nits_of):
    """Run ``launch(state, r, log) -> state`` over ``rounds`` rounds with
    a fresh log, in pieces of at most ``MAX_LOG_BYTES``, until the budget
    is spent or no instance ran a whole piece.  Returns ``(state,
    pieces)`` for :func:`emit`."""
    step = max(1, MAX_LOG_BYTES // (b * width * 4))
    pieces = []
    left = rounds
    while left > 0:
        r = min(left, step)
        log = torch.zeros((b, r, width), dtype=torch.int32, device=device)
        before = nits_of(state)
        state = launch(state, r, log)
        counts = nits_of(state) - before
        pieces.append((log, counts))
        left -= r
        if bool((counts < r).all()):
            break
    return state, pieces


def launch_traced(launch, state, rounds: int, trace_rows, fmt: str, b: int,
                  width: int, device, nits_of):
    """Run a kernel wrapper's ``launch(state, r, log) -> state`` with the
    round trace: no log when tracing is off and ``trace_rows`` is None;
    ``trace_rows`` (zeroed first) as the log where it is given; else a
    fresh log in pieces (:func:`run_logged`).  Prints the rows with
    ``fmt`` when tracing is on."""
    if trace_rows is None and not is_enabled():
        return launch(state, rounds, None)
    if trace_rows is None:
        state, pieces = run_logged(launch, state, rounds, b, width, device,
                                   nits_of)
    else:
        trace_rows.zero_()
        before = nits_of(state)
        state = launch(state, rounds, trace_rows)
        pieces = [(trace_rows, nits_of(state) - before)]
    if is_enabled():
        emit(fmt, pieces)
    return state


def plain_rows(rows: list, trace_rows, fmt: str, counts, b: int,
               width: int, device) -> None:
    """The plain versions' end of the trace: ``rows`` holds one ``[B, W]``
    int32 row a round run (zero for an instance that did not run it);
    fills ``trace_rows`` where it is given and prints when tracing is
    on.  ``counts [B]`` are the rounds each instance ran."""
    got = (torch.stack(rows, dim=1) if rows else
           torch.zeros((b, 0, width), dtype=torch.int32, device=device))
    if trace_rows is not None:
        trace_rows.zero_()
        trace_rows[:, :got.shape[1]] = got
    if is_enabled():
        emit(fmt, [(got, counts)])
