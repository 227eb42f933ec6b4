"""The program's own spans in a traced window, and the device operations
each host call enqueued.

``jwave_pro_tpu_torch`` marks its stages with ``utils.profiling.span``:
``record_function`` events named ``jwave.*`` on the calling thread, which
``tracing.parse`` keeps among the window's host events, on the clock the
device's operations are aligned to.  A program without them (an older
checkout) leaves every reader here with nothing: an empty list, 0, or
None, never an error.
"""
from __future__ import annotations

import bisect

from . import tracing

# host calls that put one operation on a stream, by the category of the
# device operation: a kernel, a copy or a fill
ENQUEUES = {"kernel": ("cudaLaunch", "cuLaunch"),
            "gpu_memcpy": ("cudaMemcpy", "cuMemcpy"),
            "gpu_memset": ("cudaMemset", "cuMemset")}


def named(trace: tracing.Trace, name: str) -> list[tuple[float, float]]:
    """(start, end) of every host event called ``name``, by start."""
    return [(s, e) for n, s, e in trace.host if n == name]


def prefixed(trace: tracing.Trace, prefix: str) -> list[tuple[float, float]]:
    """(start, end) of every host event whose name starts with ``prefix``."""
    return [(s, e) for n, s, e in trace.host if n.startswith(prefix)]


def covered(intervals) -> float:
    """Microseconds covered by the union of ``intervals``."""
    return sum(e - s for s, e in tracing.merge(intervals))


def overlap(a, b) -> float:
    """Microseconds that lie both in the union of ``a`` and in the union
    of ``b``."""
    a, b = tracing.merge(a), tracing.merge(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def per_call(trace: tracing.Trace, intervals) -> list[float]:
    """For each of the harness's calls, the microseconds of ``intervals``
    inside it."""
    return [overlap(intervals, [call]) for call in named(trace, tracing.CALL)]


def enqueues(trace: tracing.Trace) -> list[tuple[float, str]]:
    """(start, kind of operation) of each host call in the window that
    put one operation on a stream, by start; one inside another (a
    ``cuLaunchKernel`` under a ``cudaLaunchKernel``) is the same one."""
    out, end = [], float("-inf")
    for name, s, e in trace.host:           # by start, outer events first
        kind = next((k for k, p in ENQUEUES.items() if name.startswith(p)),
                    None)
        if kind and s >= end:
            out.append((s, kind))
            end = e
    return out


def matched(trace: tracing.Trace):
    """The window's device operations beside the host calls that enqueued
    them: a list of (enqueue's start, device operation), or None.

    On one stream the operations run in the order they were enqueued, so
    the i-th operation is the i-th enqueue's.  The host's and the
    device's clocks are aligned only to some hundreds of microseconds, so
    nothing here compares a device time with a host time: a window edge
    may lose the operations the alignment moves past it, and the two
    sequences are then matched with that many dropped at the start or at
    the end.  A match holds only where every pair agrees in kind
    (kernel, copy, fill) and exactly one way of dropping fits; else
    nothing is matched rather than something wrongly (another stream, a
    call that enqueues nothing or two operations)."""
    hosts = enqueues(trace)
    ops = sorted(trace.device, key=lambda op: op[2])
    if not hosts or not ops:
        return None
    k = abs(len(hosts) - len(ops))
    fits = []
    for first in sorted({0, k}):
        h = hosts[first:] if len(hosts) > len(ops) else hosts
        o = ops[first:] if len(ops) > len(hosts) else ops
        pairs = list(zip(h, o))
        if all(kind == op[1] for (_, kind), op in pairs):
            fits.append([(at, op) for (at, _), op in pairs])
    return fits[0] if len(fits) == 1 else None


def inside(point: float, intervals) -> bool:
    """Whether ``point`` lies in one of the disjoint, sorted
    ``intervals``."""
    i = bisect.bisect_right(intervals, (point, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= point < intervals[i][1]
