"""Cells cut to sizes a CPU test holds."""
from __future__ import annotations

from pathlib import Path

from wavebench import core

ROOT = Path(core.__file__).resolve().parents[1]
CELLS = ("modwt_db4_l5.batch", "cwt_morlet6_s64.batch",
         "modwt_db4_l5.denoise", "modwt_db4_l5.stream")


def small(name: str) -> core.Cell:
    """Cell ``name`` with its traffic cut to a few hundred samples a row;
    every other setting, the limits included, as committed."""
    cell = core.load_cell(name)
    w = cell.workload
    w["rows"] = 4
    if w["lengths"]["kind"] == "fixed":
        n = 512 if w["entry"] == "stream_update" else 1024
        w["lengths"] = dict(w["lengths"], n=n, count=min(
            w["lengths"].get("count", 1), 3))
    else:
        w["lengths"] = dict(w["lengths"], count=6, low=700, high=3000)
    if "buffer" in w:
        w.update(buffer=2048, host_pool=32)
    w["trace_calls"] = 4
    return cell
