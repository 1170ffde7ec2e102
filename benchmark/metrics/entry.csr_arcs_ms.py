"""``entry.csr_arcs_ms``: per call, the host time of the program's
``slap.csr_arcs`` spans that start inside the call (``KhoslaSolver``'s
CSR rows scattered into arc slots on the device, their copy included),
summed; the mean over the traced calls, in ms.  Nothing when the
program marks no such span."""

from benchmark.timeline import Records

SPAN = "slap.csr_arcs"


def read(rec: Records):
    spans = [(o.start, o.end - o.start) for o in rec.host_ops
             if o.name == SPAN]
    inside = [[d for s, d in spans if lo <= s <= hi] for lo, hi in rec.calls]
    if not any(inside):
        return None
    return sum(map(sum, inside)) / len(inside) / 1e3
