"""What the program's spans cost, for comparing two trees.

    python3 probes/span_cost_probe.py [ROOT] [--cells a,b] [--seed N]

Imports ``jwave_pro_tpu_torch`` and ``wavebench`` from ROOT (default:
this checkout) and prints one JSON line with the card's name and power
limit and:

* where ROOT's ``utils.profiling`` has ``span``: the host µs one span
  site costs with no profiler running, ``with span(name)`` and a call of
  a ``spanned`` function, each less the bare loop or call (10⁶
  iterations, median of 5), and ``with span(name)`` with a CPU profiler
  running (10⁴ iterations);
* for each cell (default: every cell of ROOT's ``BENCHMARK.json``),
  after set-up from ``--seed``: a closed-loop cell's median host µs a
  call with no profiler (the harness's measured window, ``--seconds``,
  as ``enqueue_ms`` reads it); then the harness's traced window: the
  median and mean host µs inside a call (the harness's ``wavebench.call``
  span), the host events a call by category, the calls, the window's
  seconds, the device's idle ms whose gap the breakdown labels with the
  bare ``wavebench.call`` (the host inside a call but in no event of its
  own), and for each launch span name the median µs of the span and of
  the host events directly inside it, by name (``other``: the span's
  time in none of them).

Each number depends on the host's load, so two trees are compared only
within one machine session, run alternately (parent, change, change,
parent).
"""
import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
parser.add_argument("--cells", default="")
parser.add_argument("--seed", type=int, default=2147483647)
parser.add_argument("--seconds", type=float, default=3.0)
ARGS = parser.parse_args()
ROOT = Path(ARGS.root).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from jwave_pro_tpu_torch.utils import profiling  # noqa: E402
from wavebench import core, tracing  # noqa: E402


def loop_us(body, n: int, runs: int = 5) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        body(n)
        times.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(times)


def span_costs() -> dict:
    span, spanned = profiling.span, profiling.spanned

    def bare(n):
        for _ in range(n):
            pass

    def with_span(n):
        for _ in range(n):
            with span("jwave.probe"):
                pass

    def plain():
        return None

    wrapped = spanned("jwave.probe")(plain)

    def call_plain(n):
        for _ in range(n):
            plain()

    def call_wrapped(n):
        for _ in range(n):
            wrapped()

    n = 1_000_000
    out = {"span_off_us": loop_us(with_span, n) - loop_us(bare, n),
           "spanned_off_us": loop_us(call_wrapped, n)
           - loop_us(call_plain, n)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["span_on_us"] = loop_us(with_span, 10_000, 3) \
            - loop_us(bare, 10_000, 3)
    return out


def events_per_call(events: list, calls: int) -> dict:
    """Host events of the traced window's thread a call, by category."""
    window = next(e for e in events if e.get("name") == tracing.WINDOW)
    lo, hi = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    out: dict = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("tid") == window.get("tid")
                and e.get("cat") in tracing.HOST_CATS
                and lo <= float(e["ts"]) < hi):
            out[e["cat"]] = out.get(e["cat"], 0) + 1
    return {k: v / calls for k, v in sorted(out.items())}


def launch_split(trace) -> dict:
    """Median µs a launch of each ``jwave.launch.*`` span and of the host
    events directly inside it, by name."""
    host = trace.host                        # by start, outer events first
    starts = [h[1] for h in host]
    by_launch: dict = {}
    for i, (name, lo, hi) in enumerate(host):
        if not name.startswith("jwave.launch."):
            continue
        parts, end = {"span": hi - lo}, lo
        j = i + 1
        while j < len(host) and starts[j] < hi:
            child, s, e = host[j]
            if s >= end:                     # not inside an earlier child
                parts[child] = parts.get(child, 0.0) + e - s
                end = e
            j += 1
        parts["other"] = parts["span"] - sum(
            v for k, v in parts.items() if k != "span")
        by_launch.setdefault(name, []).append(parts)
    out = {}
    for name, launches in by_launch.items():
        keys = {k for parts in launches for k in parts}
        out[name] = {k: statistics.median(p.get(k, 0.0) for p in launches)
                     for k in sorted(keys)}
    return out


def cell_window(name: str, seed: int) -> dict:
    cell = core.load_cell(name)
    device = torch.device("cuda")
    entry = core.make_entry(cell, seed, device)
    driver = core.Driver(entry, cell.workload["loop"], device)
    win = driver.measure(ARGS.seconds)
    captured = []
    capture = tracing.capture
    tracing.capture = lambda *a: captured.append(capture(*a)) or captured[-1]
    try:
        trace = driver.traced(cell.workload["trace_calls"],
                              cell.workload.get("warm_trace_calls", 2))
    finally:
        tracing.capture = capture
    calls = [e - s for n, s, e in trace.host if n == tracing.CALL]
    bare = sum(sec for label, sec in trace.gap_labels()
               if label == tracing.CALL)
    entry.release()
    del entry, driver
    gc.collect()
    torch.cuda.empty_cache()
    return {"untraced_call_us_median":
            1e6 * statistics.median(win.enqueue_s) if win.enqueue_s
            else None,
            "call_us_median": statistics.median(calls),
            "call_us_mean": statistics.fmean(calls), "calls": len(calls),
            "events_per_call": events_per_call(captured[-1], len(calls)),
            "window_s": trace.window_s, "idle_bare_call_ms": 1e3 * bare,
            "launch_split_us": launch_split(trace)}


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    out = {"root": str(ROOT), "card": card}
    if hasattr(profiling, "span"):
        out.update(span_costs())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = ARGS.cells.split(",") if ARGS.cells else [
        w["name"] for w in spec["workloads"]]
    for name in cells:
        out[name] = cell_window(name, ARGS.seed)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
