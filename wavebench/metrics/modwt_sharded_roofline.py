"""The signal-sharded forward's share of its roofline: the least time an
H100 could take for one rank's part of the traced calls (the forward of
its (rows, n / ranks) shard, ``roofline.modwt_fwd``'s bytes and
operations, plus the halo of (M − 1)(2^L − 1) samples a row that the
forward reads beside its shard) over that rank's device busy time in the
traced window, every operation counted (the context variant of kernel #1,
the hop's copy and its NCCL kernel)."""
import math

from wavebench import roofline
from wavebench.reference import filters


def read(r):
    w, config = r.cell.workload, r.cell.config
    if w["entry"] != "modwt_sharded" or w["lengths"]["kind"] != "fixed":
        return None
    busy = r.trace.busy_s
    if not busy or not r.trace.calls:
        return None
    taps = len(filters.BY_NAME[config["wavelet"]][0])
    level = config["level"]
    rows, n = w["rows"], w["lengths"]["n"] // math.prod(
        config["mesh"].values())
    halo = (taps - 1) * ((1 << level) - 1)
    cells = rows * n
    t, _ = roofline.bound(4 * cells * (level + 2) + 4 * rows * halo,
                          cells * 4 * taps * level)
    return 100.0 * t * r.trace.calls / busy
