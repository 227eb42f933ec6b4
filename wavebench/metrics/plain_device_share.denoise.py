"""The denoise's device time outside the port's own kernels: the share of
kernel time in the traced window spent in kernels whose name does not
start with ``jw_`` (the threshold's sort and median, the shrink, the
concatenation)."""
import re

OWN = re.compile(r"^(void\s+)?jw_")


def read(r):
    if r.cell.workload["entry"] != "modwt_denoise":
        return None
    kernels = r.trace.kernels()
    total = sum(e - s for _, _, s, e in kernels)
    if not total:
        return None
    plain = sum(e - s for name, _, s, e in kernels if not OWN.match(name))
    return 100.0 * plain / total
