"""``kernels.ksp_ladder_roofline``: the arc ladder kernel's share of its
roofline, in %: the least time the calls' problems need (the entry's
``work``, bytes once at the card's bandwidth or operations at the
float32 rate, whichever is larger) over the time in which the kernel
ran, the union of the device operations whose names hold its symbol,
over the calls that ran it.  Nothing where no call ran it."""

from benchmark.peaks import least_seconds
from benchmark.timeline import Records, union

SYMBOL = "ksp_arcs_ladder_kernel"


def read(rec: Records):
    spans = [[(o.start, o.end) for o in ops if SYMBOL in o.name]
             for ops in rec.call_ops()]
    busy = sum(sum(b - a for a, b in union(s)) for s in spans if s)
    calls = sum(1 for s in spans if s)
    if busy <= 0:
        return None
    return 100.0 * calls * least_seconds(rec.work, rec.peaks) * 1e6 / busy
