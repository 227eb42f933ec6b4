"""The MODWT round trip's share of its roofline: the least time an H100
could take for the traced calls over the device's busy time in the traced
window, every operation counted, whatever kernels carry the two
transforms.

A call's bound adds the inverse's work to the forward's of
``roofline.modwt_fwd``: the forward reads the (B, N) signal and writes
its L + 1 rows, the inverse reads the L + 1 rows and writes the signal,
4·(L + 2)·B·N bytes each; both do one multiply-add a tap, output sample
and branch, two branches a level, 4·M·L·B·N operations each."""
from wavebench import roofline
from wavebench.reference import filters


def call_bound(rows: int, n: int, level: int, taps: int) -> float:
    """Seconds: the least time of one forward and inverse."""
    cells = rows * n
    t, _ = roofline.bound(2 * 4 * cells * (level + 2),
                          2 * cells * 4 * taps * level)
    return t


def read(r):
    w = r.cell.workload
    if w["entry"] != "modwt_roundtrip" or w["lengths"]["kind"] != "fixed":
        return None
    busy = r.trace.busy_s
    if not busy or not r.trace.calls:
        return None
    taps = len(filters.BY_NAME[r.cell.config["wavelet"]][0])
    t = call_bound(w["rows"], w["lengths"]["n"], r.cell.config["level"],
                   taps)
    return 100.0 * t * r.trace.calls / busy
