"""The share of the traced window in which no operation runs on the card:
kernels, copies and fills merged into busy intervals, the window running
from the harness's first call to its final synchronise."""


def read(r):
    window = r.trace.window_s
    if window <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / window)
