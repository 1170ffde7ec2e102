"""Tracing: gated host, round and in-kernel round prints, a profiler
context, and named spans in the profiler's timeline.

The prints are gated on the same ``SLAP_TPU_DEBUG`` environment variable
as the JAX package.  PyTorch runs eagerly, so a round trace formats its
tensors when it is called (which synchronises with the device); with
tracing off the calls cost one flag test.  The spans (:func:`span`) are
gated on a ``torch.profiler`` recording instead.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterator

import torch

#: the program's spans, host events on the profiler's clock beside the
#: device operations; each is read by a metric of the benchmark
SOLVE_BATCH_SPAN = "slap.solve_batch"  # the whole of ``solve_batch``
WAIT_SPAN = "slap.wait"  # a solver driver's blocking progress readback
FINISH_SPAN = "slap.finish"  # ``solve_batch`` after its driver
INVERT_SPAN = "slap.invert"  # ``solution``'s two inversions
SPANS = (SOLVE_BATCH_SPAN, WAIT_SPAN, FINISH_SPAN, INVERT_SPAN)

_NO_SPAN = contextlib.nullcontext()

_DEBUG = bool(os.environ.get("SLAP_TPU_DEBUG"))


def set_debug(enabled: bool) -> None:
    """Enable or disable the gated traces."""
    global _DEBUG
    _DEBUG = bool(enabled)


def is_enabled() -> bool:
    """Whether tracing is currently enabled."""
    return _DEBUG


def trace_host(fmt: str, *args) -> None:
    """Driver-level event (chunk hand-offs, modes) printed to stderr
    when tracing is enabled."""
    if _DEBUG:
        print(fmt.format(*args), file=sys.stderr, flush=True)


def trace_round(fmt: str, *args) -> None:
    """Per-round trace of the plain rounds; tensor arguments are
    printed as lists."""
    if _DEBUG:
        vals = [a.tolist() if hasattr(a, "tolist") else a for a in args]
        print(fmt.format(*vals), file=sys.stderr, flush=True)


def trace_kernel_round(fmt: str, *args) -> None:
    """One round of a kernel's in-kernel trace (the JAX package's
    ``pl.debug_print`` sites in its three round kernels), printed to
    stderr when tracing is enabled.  The CUDA kernels log their rows on
    the card and the wrappers print them after the launch
    (``ops/round_log.py``); the plain versions print the same rows."""
    if _DEBUG:
        print(fmt.format(*args), file=sys.stderr, flush=True)


def span(name: str):
    """A context that marks a span ``name`` in the timeline of a
    ``torch.profiler`` recording in this thread
    (``torch.profiler.record_function``), or, with no recording, one
    shared null context: a span costs one flag test then.  Independent of
    ``SLAP_TPU_DEBUG`` and :func:`set_debug`, which gate the prints."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


#: the Chrome trace's file name inside ``profile_solve``'s ``log_dir``
TRACE_FILE = "slap_torch_trace.json"


@contextlib.contextmanager
def profile_solve(log_dir: str = "/tmp/slap_tpu_profile") -> Iterator:
    """Profile a solve with ``torch.profiler`` (CPU and, where present,
    CUDA activity) and write a Chrome trace into the directory
    ``log_dir`` (created if missing) as :data:`TRACE_FILE`; the JAX
    package's keyword and default.  Yields the profiler:
    ``with profile_solve() as prof: solve_batch(...)``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
