"""One run of one cell: set-up, the measured window, the traced window and
the check, as the cell's files say.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its
configuration is ``configs/<config>.json``, its traffic
``workloads/<cell>.json``, which names the entry (``entries/<entry>.py``:
the call into the program and the check of its answers) and how the calls
arrive (``loop``: ``back_to_back``, each call enqueued as soon as the last
one returns, or ``closed``, each call waited for before the next).  A
per-layer metric is ``metrics/<metric>.py``, whose ``read`` takes a
:class:`Reading` and returns a number, or None where it finds nothing.
An end-to-end metric named ``<quantity>.<part>`` is one quantity split
by cells (:func:`quantity`).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from . import tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jwave_pro_tpu")
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list
    here: Path = HERE     # the folder whose files describe the cell


def _reported_in(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, manifest: Path = ROOT / "BENCHMARK.json",
              here: Path = HERE) -> Cell:
    """The cell ``name`` of the manifest, with its configuration's and its
    traffic's files."""
    spec = json.loads(manifest.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {manifest.name}")
    cell = cells[name]
    config = json.loads((here / "configs" / f"{cell['config']}.json")
                        .read_text())
    workload = json.loads((here / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if workload.get(key) != cell[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{workload.get(key)!r}, the manifest "
                             f"{cell[key]!r}")
    return Cell(name, cell["chips"], config, workload,
                [m for m in spec["end_to_end"] if _reported_in(m, name)],
                [m for m in spec["per_layer"] if _reported_in(m, name)],
                here)


def make_entry(cell: Cell, seed: int, device, dtype=torch.float32):
    """The cell's entry, its inputs made from ``seed`` and its shapes
    warmed up.  ``dtype`` other than float32 is the lower-precision
    control (``control.py``), never a benchmark run."""
    module = importlib.import_module(
        f"wavebench.entries.{cell.workload['entry']}")
    return module.Entry(cell.config, cell.workload, seed,
                        torch.device(device), dtype)


def quantity(name: str) -> str:
    """What an end-to-end metric measures: its name up to the first dot.
    A suffix splits one quantity by the cells that report it
    (``samples_per_s.cwt``), so that each part has a bound of its own."""
    return name.split(".")[0]


def metric_reader(name: str, here: Path = HERE):
    """The module ``metrics/<name>.py`` (names hold dots, so it is loaded
    from its path)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "wavebench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time against the boot clock, to the kernel's 10 ms tick)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Latency:
    """A closed-loop call's time from its start until its result is
    synchronised.  On the card, CUDA events on the stream: the stream is
    idle when a call starts, so the first event stamps the call's start
    and the second the end of its last operation, to the event timer's
    half microsecond, where the host clock would be off by some tenths of
    a millisecond.  On the CPU (tests only) the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def begin(self) -> None:
        if self.cuda:
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def finish_ms(self) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return (time.perf_counter() - self.t0) * 1e3


@dataclasses.dataclass
class Window:
    calls: int = 0
    samples: int = 0
    seconds: float = 0.0
    latency_ms: list = dataclasses.field(default_factory=list)
    enqueue_s: list = dataclasses.field(default_factory=list)
    failed: int = 0
    first_failure: str = ""


class Driver:
    """Sends the entry's calls in its pool's order, round after round."""

    def __init__(self, entry, loop: str, device: torch.device):
        if loop not in ("back_to_back", "closed"):
            raise ValueError(f"unknown loop {loop!r}")
        self.entry, self.closed, self.device = entry, loop == "closed", device
        self.at = 0

    def next_index(self) -> int:
        i = self.entry.order[self.at % len(self.entry.order)]
        self.at += 1
        return i

    def measure(self, seconds: float) -> Window:
        """Calls for ``seconds`` of the host's clock; the window ends once
        the card has finished every call enqueued in it."""
        win, entry = Window(), self.entry
        clock = Latency(self.device)
        sync(self.device)
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while True:
            i = self.next_index()
            if self.closed:
                clock.begin()
            h0 = time.perf_counter()
            try:
                entry.call(i)
            except Exception:  # a refused call counts as failed; go on
                win.failed += 1
                win.first_failure = win.first_failure or \
                    traceback.format_exc()
            else:
                win.samples += entry.samples[i]
            h1 = time.perf_counter()
            if self.closed:
                win.latency_ms.append(clock.finish_ms())
                win.enqueue_s.append(h1 - h0)
            win.calls += 1
            if h1 >= t_end:
                break
        sync(self.device)
        win.seconds = time.perf_counter() - t0
        return win

    def traced(self, calls: int, warm_calls: int) -> tracing.Trace:
        """A profiler trace of ``calls`` calls, after ``warm_calls`` under
        a profiler of its own."""
        record = torch.profiler.record_function

        def run(count):
            for _ in range(count):
                i = self.next_index()
                with record(tracing.CALL):
                    self.entry.call(i)
                if self.closed:
                    with record(tracing.SYNC):
                        sync(self.device)
            with record(tracing.SYNC):
                sync(self.device)

        sync(self.device)
        return tracing.parse(tracing.capture(lambda: run(calls),
                                             lambda: run(warm_calls)))


@dataclasses.dataclass
class Reading:
    """What the per-layer metrics of a traced run read."""

    cell: Cell
    window: Window
    trace: tracing.Trace


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (NumPy's
    default rule)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def end_to_end(win: Window, setup_s: float, peak_bytes: int) -> dict:
    """Every end-to-end metric the window gives."""
    out = {"samples_per_s": win.samples / win.seconds,
           "peak_mem_gib": peak_bytes / GIB,
           "setup_s": setup_s}
    if win.latency_ms:
        out["p95_ms"] = percentile(win.latency_ms, 95)
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX, its libraries or the JAX package, by whole
    top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    """One run of ``cell``; returns the result line's object."""
    device = torch.device(device)
    sync(device)                # the card's context, before the inputs
    before_entry = process_age()
    entry = make_entry(cell, seed, device)
    driver = Driver(entry, cell.workload["loop"], device)
    # set-up's garbage is collected, and what it keeps frozen, before the
    # window rather than in it
    gc.collect()
    gc.freeze()
    sync(device)
    setup_s = process_age()
    # where set-up went; the first warm-up call loads, or builds, the
    # kernels' library
    print(f"setup: {before_entry:.3f} s interpreter, torch and the card's "
          f"context; {setup_s - before_entry:.3f} s inputs and warm-up",
          file=sys.stderr)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = driver.measure(seconds)
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda
            else device.type,
            "count": cell.chips,
            "memory_peak_bytes": window_peak}
    result = {"correct": False, "attempted": win.calls, "failed": win.failed}
    if trace:
        shot = driver.traced(cell.workload["trace_calls"],
                             cell.workload.get("warm_trace_calls", 2))
        reading = Reading(cell, win, shot)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.here).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info.update(busy_s=shot.busy_s, window_s=shot.window_s)
        result["attempted"] += shot.calls
        extra = {"breakdown": tracing.breakdown(shot)}
    else:
        values = end_to_end(win, setup_s, window_peak)
        metrics = {m["name"]: {"value": values[quantity(m["name"])],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
        extra = {}
    entry.release()
    limits = cell.workload["check"]["limits"]
    found = entry.check()
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in found.items()}
    result["correct"] = (win.failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values()))
    if win.first_failure:
        result["first_failure"] = win.first_failure
    # the checks come last, where the end of a printed line keeps them
    result.update(metrics=metrics, device=info, **extra, checks=checks)
    return result
