"""``entry.host_head_ms``: per call, the host time from the call span's
start to the start of its first device operation; the mean over the
traced calls, in ms."""

from benchmark.timeline import Records


def read(rec: Records):
    heads = [ops[0].start - lo
             for (lo, _), ops in zip(rec.calls, rec.call_ops()) if ops]
    return sum(heads) / len(heads) / 1e3 if heads else None
