"""Device kernels an interval (replay loop): the kernel launches the
profiler saw in the traced window (copies and sets left out), over the
intervals of its passes."""
from perfbench import devtrace


def read(rec):
    if not rec.events or not rec.intervals:
        return None
    return sum(devtrace.is_kernel(nm) for nm, _, _ in rec.events) \
        / rec.intervals
