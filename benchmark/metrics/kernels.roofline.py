"""``kernels.roofline``: the least time the calls' problems need (bytes
once at the card's bandwidth, or its operations at the float32 rate,
whichever is larger; counted from the cell's shapes, never from a
kernel) over the time in which the calls' device operations ran, in %.
"""

from benchmark.peaks import least_seconds
from benchmark.timeline import Records, union


def read(rec: Records):
    busy = sum(sum(b - a for a, b in union((o.start, o.end) for o in ops))
               for ops in rec.call_ops() if ops)
    calls = sum(1 for ops in rec.call_ops() if ops)
    if busy <= 0:
        return None
    return 100.0 * calls * least_seconds(rec.work, rec.peaks) * 1e6 / busy
