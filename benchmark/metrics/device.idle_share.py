"""``device.idle_share``: the share of the traced window in which no
device operation ran, in %."""

from benchmark.timeline import Records, busy_us


def read(rec: Records):
    lo, hi = rec.window
    if not rec.device_ops or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_us(rec) / (hi - lo))
