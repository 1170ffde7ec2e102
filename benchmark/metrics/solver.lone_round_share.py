"""``solver.lone_round_share``: per call, the share in percent of the
eps-scaling ladder's rounds that its lone chain runs (a round of one
active person over rows that fit the burst), from the program's
``slap.lone_rounds`` counters (one a batch: a span of no length named
``slap.lone_rounds=<lone rounds>,<rounds>``, both summed over the batch)
that start inside the call: the call's lone rounds over its rounds; the
mean over the traced calls that hold one.  Nothing where the program
marks no such counter."""

from benchmark.timeline import Records

COUNTER = "slap.lone_rounds="


def read(rec: Records):
    marks = [(o.start, [int(v) for v in o.name[len(COUNTER):].split(",")])
             for o in rec.host_ops if o.name.startswith(COUNTER)]
    per_call = []
    for lo, hi in rec.calls:
        counts = [v for s, v in marks if lo <= s <= hi]
        rounds = sum(v[1] for v in counts)
        if rounds > 0:
            per_call.append(100.0 * sum(v[0] for v in counts) / rounds)
    if not per_call:
        return None
    return sum(per_call) / len(per_call)
