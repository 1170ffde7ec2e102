"""``sharded.nccl_ms``: per call, the device time of the kernels whose
names hold ``nccl`` (the collectives), on rank 0; the mean over the
traced calls, in ms."""

from benchmark.timeline import Records


def read(rec: Records):
    per_call = [sum(o.end - o.start for o in ops if "nccl" in o.name.lower())
                for ops in rec.call_ops()]
    if not any(per_call):
        return None
    return sum(per_call) / len(per_call) / 1e3
