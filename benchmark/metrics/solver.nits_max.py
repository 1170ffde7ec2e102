"""``solver.nits_max``: per call, the largest ``nits`` among the
returned instances (the slowest instance's rounds); the mean over the
traced calls."""

from benchmark.timeline import Records


def read(rec: Records):
    nits = rec.nits_max[:len(rec.calls)]
    return sum(nits) / len(nits) if nits else None
