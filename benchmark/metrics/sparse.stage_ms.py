"""``sparse.stage_ms``: per call, the host time of the program's
``slap.stage`` spans that start inside the call (the sparse entry
points' staging: checks, the plane or the arcs on the device, the drop
thresholds), summed; the mean over the traced calls, in ms.  Nothing
when the program marks no such span."""

from benchmark.timeline import Records

SPAN = "slap.stage"


def read(rec: Records):
    spans = [(o.start, o.end - o.start) for o in rec.host_ops
             if o.name == SPAN]
    inside = [[d for s, d in spans if lo <= s <= hi] for lo, hi in rec.calls]
    if not any(inside):
        return None
    return sum(map(sum, inside)) / len(inside) / 1e3
