"""The 2D denoise's share of its roofline: the least time an H100 could
take for the traced calls over the device's busy time in the traced
window, every operation counted, so the share is the same whatever
carries the denoise (the transforms with the shrink between them, or one
fused kernel that writes no coefficients).

A call's bound is the work of a denoise of (B, R, C) float32 frames at L
levels with M taps: the frames read and the result written once, and a
threshold a frame, 4·(2·B·R·C + B) bytes; a cascade level's two quadrant
pairs and the passes before them, 12M operations a pixel, forward and
inverse, and a shrink of each of its three detail bands, 3 a value,
B·R·C·(24·M + 9)·L operations, the count kernel #11 is measured against
(Db4 L3 at (16, 2048, 2048): 0.604 ms, set by the operations)."""
import math

from wavebench import roofline
from wavebench.reference import filters


def call_bound(frames: int, shape, level: int, taps: int) -> float:
    """Seconds: the least time of one denoise call."""
    pixels = frames * math.prod(shape)
    t, _ = roofline.bound(4 * (2 * pixels + frames),
                          pixels * (24 * taps + 9) * level)
    return t


def read(r):
    w, config = r.cell.workload, r.cell.config
    if w["entry"] != "modwt2_denoise":
        return None
    busy = r.trace.busy_s
    if not busy or not r.trace.calls:
        return None
    taps = len(filters.BY_NAME[config["wavelet"]][0])
    t = call_bound(w["rows"], w["frame"], config["level"], taps)
    return 100.0 * t * r.trace.calls / busy
