"""Device milliseconds an interval: the union of every device activity
of the traced window (kernels of any origin, copies and sets), over the
intervals of its passes.  Work that moves between kernels, or into a
kernel that no other metric names, stays in it."""
from perfbench import devtrace


def read(rec):
    if not rec.events or not rec.intervals:
        return None
    return devtrace.busy_ns(rec.events) / 1e6 / rec.intervals
