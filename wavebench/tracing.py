"""The traced window: a ``torch.profiler`` trace of the cell's own calls,
and what the per-layer metrics and the breakdown read from it.

The harness marks its own spans with ``record_function``: the whole
traced window (``wavebench.window``), each call into the program
(``wavebench.call``) and each wait for the card (``wavebench.sync``).
They share the trace's clock with the device's operations, so an idle
gap on the device can be named by what the host was doing at its start.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
from pathlib import Path

import torch

WINDOW, CALL, SYNC = "wavebench.window", "wavebench.call", "wavebench.sync"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120
TOP = 10


def capture(calls, warm_calls) -> list[dict]:
    """The trace events of ``calls()`` run inside ``wavebench.window``.

    ``warm_calls()`` runs under a profiler of its own first: the first
    profiled steps in a process carry the profiler's start-up work on the
    host, which would otherwise land in the traced window.  The trace is
    written to, and read back from, a temporary directory under
    ``TMPDIR``, removed afterwards.
    """
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        warm_calls()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            calls()
    with tempfile.TemporaryDirectory(prefix="wavebench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


@dataclasses.dataclass
class Trace:
    """A traced window, times in microseconds of the trace's clock."""

    lo: float
    hi: float
    device: list      # (name, cat, start, end) of each device operation
    host: list        # (name, start, end) of the window's thread, by start
    calls: int

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """Merged intervals in which some operation ran on the device,
        clipped to the window."""
        clipped = [(max(s, self.lo), min(e, self.hi))
                   for _, _, s, e in self.device]
        return merge((s, e) for s, e in clipped if e > s)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def kernels(self) -> list:
        return [op for op in self.device if op[1] == "kernel"]

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the device inside the window, those before
        its first operation and after its last one included."""
        out, at = [], self.lo
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.hi > at:
            out.append((at, self.hi))
        return out

    def gap_labels(self) -> list[tuple[str, float]]:
        """Each idle gap as (what the host was doing at its start, seconds):
        the harness span and the innermost host event around it.  Host
        events on one thread nest, so a sweep keeps the open ones on a
        stack."""
        out, stack, i = [], [], 0
        for s, e in self.gaps():
            while i < len(self.host) and self.host[i][1] <= s:
                event = self.host[i]
                while stack and stack[-1][2] <= event[1]:
                    stack.pop()
                stack.append(event)
                i += 1
            while stack and stack[-1][2] < s:
                stack.pop()
            names = [name for name, _, _ in stack if name != WINDOW]
            harness = [n for n in names if n.startswith("wavebench.")]
            if not names:
                label = "harness"
            elif harness and harness[-1] != names[-1]:
                label = f"{harness[-1]}/{names[-1]}"
            else:
                label = names[-1]
            out.append((label[:NAME_CHARS], (e - s) / 1e6))
        return out


def parse(events: list[dict]) -> Trace:
    """The traced window of a ``capture`` trace."""
    spans = [e for e in events if e.get("ph") == "X"]
    window = [e for e in spans if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise ValueError(f"the trace holds {len(window)} traced windows")
    lo = float(window[0]["ts"])
    tid = window[0].get("tid")
    hi = lo + float(window[0]["dur"])

    def inside(e):
        s = float(e["ts"])
        return s < hi and s + float(e.get("dur", 0)) > lo

    device = [(e["name"], e["cat"], float(e["ts"]),
               float(e["ts"]) + float(e["dur"]))
              for e in spans if e.get("cat") in DEVICE_CATS and inside(e)]
    host = sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]))
                   for e in spans if e.get("cat") in HOST_CATS
                   and e.get("tid") == tid and inside(e)),
                  key=lambda h: (h[1], -h[2]))
    calls = sum(1 for name, _, _ in host if name == CALL)
    return Trace(lo, hi, device, host, calls)


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the device's idle
    time summed by what the host was doing, each with at most ``TOP``
    entries, in seconds."""
    by_op: dict[str, float] = {}
    for name, _, s, e in trace.device:
        key = name[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (min(e, trace.hi)
                                            - max(s, trace.lo)) / 1e6
    by_host: dict[str, float] = {}
    for label, seconds in trace.gap_labels():
        by_host[label] = by_host.get(label, 0.0) + seconds
    return {"device_ops": _top(by_op), "idle_gaps": _top(by_host)}


def _top(seconds: dict) -> list:
    return [[k, v] for k, v in sorted(seconds.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
