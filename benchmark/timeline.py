"""The traced run's records: what ``torch.profiler`` saw, cut into the
harness's spans, and the interval arithmetic the metric readers share.

Times are microseconds on the profiler's clock, which puts host events
and device operations on one timeline.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

#: the harness's own spans (``torch.profiler.record_function``)
WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"
STAGE_SPAN = "bench.stage"

#: profiler categories of device operations
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

#: the longest name the breakdown keeps (kernel names of templates run
#: to thousands of characters; the head names the operation)
NAME_CHARS = 120

#: profiler categories of host events a gap may be attributed to
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver"})


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    start: float
    end: float


@dataclasses.dataclass
class Records:
    """One traced window: the window's span, each completed call's span,
    the device operations and host events inside the window, and what
    the harness counted per call."""

    window: tuple
    calls: list
    device_ops: list
    host_ops: list
    nits_max: list
    work: tuple  # (bytes, operations) of one call's problem
    peaks: dict

    def call_ops(self) -> list:
        """The device operations of each call: those that start inside
        its span (every call waits for its own device work)."""
        ops = sorted(self.device_ops, key=lambda o: o.start)
        out, i = [], 0
        for lo, hi in self.calls:
            while i < len(ops) and ops[i].start < lo:
                i += 1
            j = i
            while j < len(ops) and ops[j].start <= hi:
                j += 1
            out.append(ops[i:j])
            i = j
        return out


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(x) for x in merged]


def covered(intervals, lo: float, hi: float) -> float:
    """The length of ``[lo, hi]`` that the intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def load(path: Path, calls_wanted: list, nits_max: list, work: tuple,
         peaks: dict) -> Records:
    """Read a Chrome trace that ``torch.profiler`` exported.  Only the
    events inside the window span are kept; ``calls_wanted`` flags which
    call spans, in order, were completed inside the window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = next(((e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e.get("name") == WINDOW_SPAN
                   and e.get("cat") == "user_annotation"), None)
    if window is None:
        raise ValueError(f"no {WINDOW_SPAN} span in the trace")
    lo, hi = window

    def inside(e):
        return lo <= e["ts"] <= hi

    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e.get("name") == CALL_SPAN
                   and e.get("cat") == "user_annotation" and inside(e))
    calls = [c for c, keep in zip(calls, calls_wanted) if keep]
    device = [Op(e["name"], e["cat"], e["ts"], e["ts"] + e["dur"])
              for e in spans if e.get("cat") in DEVICE_CATS and inside(e)]
    host = [Op(e["name"], e["cat"], e["ts"], e["ts"] + e["dur"])
            for e in spans if e.get("cat") in HOST_CATS and inside(e)]
    return Records(window=window, calls=calls, device_ops=device,
                   host_ops=host, nits_max=list(nits_max), work=work,
                   peaks=peaks)


def busy_us(rec: Records) -> float:
    """Microseconds of the window in which a device operation ran."""
    return covered([(o.start, o.end) for o in rec.device_ops], *rec.window)


def breakdown(rec: Records, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    time of the device by what the host was doing meanwhile: each gap
    between device operations goes to the shortest host event that
    covers its middle (a call span with no torch operation under it is
    the program's host code)."""
    by_name: dict = {}
    for o in rec.device_ops:
        name = o.name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (o.end - o.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    lo, hi = rec.window
    busy = union((o.start, o.end) for o in rec.device_ops)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    host = sorted(rec.host_ops, key=lambda o: o.start)
    idle: dict = {}
    active, i = [], 0
    for a, b in gaps:  # in time order, so one sweep finds the covers
        mid = (a + b) / 2
        while i < len(host) and host[i].start <= mid:
            active.append(host[i])
            i += 1
        active = [o for o in active if o.end >= mid]
        who = min(active, key=lambda o: o.end - o.start, default=None)
        if who is None:
            label = "between calls (harness)"
        elif who.name == CALL_SPAN:
            label = f"{CALL_SPAN}: host code, no torch op"
        elif who.name == WINDOW_SPAN:
            label = f"{WINDOW_SPAN}: between calls (harness)"
        else:
            label = who.name
        idle[label] = idle.get(label, 0.0) + (b - a)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[k, v * 1e-6] for k, v in device_ops],
        "idle_gaps": [[k, v * 1e-6] for k, v in idle_gaps],
    }
