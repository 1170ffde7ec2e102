"""``solver.last_phase_rounds``: per call, the largest number of rounds
an instance's last phase of the eps-scaling ladder ran, from the
program's ``slap.last_phase_rounds`` counters (one a batch: a span of no
length named ``slap.last_phase_rounds=<rounds>``) that start inside the
call; the mean over the traced calls that hold one.  Nothing where the
program marks no such counter."""

from benchmark.timeline import Records

COUNTER = "slap.last_phase_rounds="


def read(rec: Records):
    marks = [(o.start, int(o.name[len(COUNTER):])) for o in rec.host_ops
             if o.name.startswith(COUNTER)]
    per_call = [[v for s, v in marks if lo <= s <= hi]
                for lo, hi in rec.calls]
    per_call = [max(v) for v in per_call if v]
    if not per_call:
        return None
    return sum(per_call) / len(per_call)
