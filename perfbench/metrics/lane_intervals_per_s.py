"""Lane-intervals per second: the lanes times the intervals of every pass
of the window, over the window's wall time on the host's clock (from the
first pass's start to the last pass's end, which waits for the device).
Read with tracing off."""


def read(rec):
    return rec.lane_intervals / rec.window_s
