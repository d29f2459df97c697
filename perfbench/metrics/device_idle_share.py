"""The device's idle share of the traced window: one minus the union of
its activities' intervals (kernels, copies, sets) over the window's wall
time."""
from perfbench import devtrace


def read(rec):
    if not rec.events:
        return None
    return 1.0 - devtrace.busy_ns(rec.events) / 1e9 / rec.window_s
