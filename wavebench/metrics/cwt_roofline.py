"""The CWT's share of its roofline: the least time an H100 could take for
the traced calls (``roofline.cwt``: the signal read, the complex64
coefficients written, the FFTs and products at the signal's own length)
over the device's busy time in the traced window, every operation
counted, so the share is the same whichever path ``method`` picks."""
from wavebench import roofline


def read(r):
    w = r.cell.workload
    if w["entry"] != "cwt" or w["lengths"]["kind"] != "fixed":
        return None
    busy = r.trace.busy_s
    if not busy or not r.trace.calls:
        return None
    t, _ = roofline.cwt(w["rows"], w["lengths"]["n"],
                        r.cell.config["scales"]["count"])
    return 100.0 * t * r.trace.calls / busy
