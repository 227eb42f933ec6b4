"""The best-basis packet denoise's share of its roofline: the least time an
H100 could take for the traced calls over the device's busy time in the
traced window, every operation counted, so the share is the same whatever
carries the denoise.

A call's bound is the work of a denoise of (B, N) float32 signals over an
L-level packet tree with M taps: the signals read and the result written
once, and a threshold a signal, 4·(2·B·N + B) bytes; a multiply-add (2
operations) a tap for each of the L analysis levels and each of the L
synthesis levels a coefficient, 4 a coefficient for the SURE cost of each
of the L + 1 levels of the tree, and 3 for the shrink,
B·N·(4·M·L + 4·(L + 1) + 3) operations (Symlet 8 L6 at (1024, 65536):
0.416 ms, set by the operations)."""
from wavebench import roofline
from wavebench.reference import wpt


def call_bound(rows: int, n: int, level: int, taps: int) -> float:
    """Seconds: the least time of one denoise call."""
    samples = rows * n
    t, _ = roofline.bound(4 * (2 * samples + rows),
                          samples * (4 * taps * level + 4 * (level + 1) + 3))
    return t


def read(r):
    w, config = r.cell.workload, r.cell.config
    if w["entry"] != "wpt_denoise":
        return None
    busy = r.trace.busy_s
    if not busy or not r.trace.calls:
        return None
    taps = len(wpt.BY_NAME[config["wavelet"]][0])
    t = call_bound(w["rows"], w["lengths"]["n"], config["level"], taps)
    return 100.0 * t * r.trace.calls / busy
