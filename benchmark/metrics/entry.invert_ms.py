"""``entry.invert_ms``: per call, the host time of the program's
``slap.invert`` spans that start inside the call (``o2p_from_p2o``, the
object-to-person map built on the host from the returned matching); the
mean over the traced calls, in ms.  Nothing when the program marks no
such span."""

from benchmark.timeline import Records

SPAN = "slap.invert"


def read(rec: Records):
    spans = [(o.start, o.end - o.start) for o in rec.host_ops
             if o.name == SPAN]
    inside = [[d for s, d in spans if lo <= s <= hi] for lo, hi in rec.calls]
    if not any(inside):
        return None
    return sum(map(sum, inside)) / len(inside) / 1e3
