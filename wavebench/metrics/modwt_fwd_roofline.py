"""The forward MODWT's share of its roofline: the least time an H100 could
take for the traced calls (``roofline.modwt_fwd``, counted from the
shapes) over the device's busy time in the traced window, every operation
counted, so the share is the same whatever kernels carry the transform."""
from wavebench import roofline
from wavebench.reference import filters


def read(r):
    w = r.cell.workload
    if w["entry"] != "modwt" or w["lengths"]["kind"] != "fixed":
        return None
    busy = r.trace.busy_s
    if not busy or not r.trace.calls:
        return None
    taps = len(filters.BY_NAME[r.cell.config["wavelet"]][0])
    t, _ = roofline.modwt_fwd(w["rows"], w["lengths"]["n"],
                              r.cell.config["level"], taps)
    return 100.0 * t * r.trace.calls / busy
