"""``entry.host_tail_ms``: per call, the host time from the end of its
last device operation to the end of the call span (the entry point's
host post-processing and readback handling); the mean over the traced
calls, in ms."""

from benchmark.timeline import Records


def read(rec: Records):
    tails = [max(0.0, hi - max(o.end for o in ops))
             for (_, hi), ops in zip(rec.calls, rec.call_ops()) if ops]
    return sum(tails) / len(tails) / 1e3 if tails else None
