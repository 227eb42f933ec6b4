"""Run cells as the check runs them, one process after another, and give
each metric's spread.

    python wavebench/sets.py --workload <cell> [--workload ...] \\
        --seeds 11,12,13,14,15,16 [--sets 2] [--seconds 10] [--trace 0] \\
        [--warm 1] [--out chiprun_out/wavebench/runs.jsonl]

Each run is ``run.py`` in a process of its own, so one process at a time
holds the card; this process never touches it.  ``--warm 1`` makes one
run of each cell first, kept apart (the first run in a checkout builds
the kernels).  Every run's result line, return code, wall time and the
end of its standard error go to ``--out``, one JSON line each.  For each
cell, set and metric it prints the median and the spread: the distance
between the first and third quartiles (``statistics.quantiles``, n = 4)
over the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 1500


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def one_run(cell: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "wavebench" / "run.py"), "--workload",
           cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=TIMEOUT_S)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = 124, exc.stdout or "", exc.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    wall = time.perf_counter() - t0
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
            "rc": rc, "wall_s": wall, "result": result,
            "stderr_tail": err[-3000:]}


def spread(values: list) -> tuple[float, float]:
    """(median, (Q3 − Q1) / median)."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", action="append", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--sets", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=10)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--warm", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", default="chiprun_out/wavebench/runs.jsonl")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    ok = True
    with out.open("a") as log:
        for cell in args.workload:
            runs = []
            plan = [(-1, seeds[0] + 7919)] if args.warm else []
            plan += [(s, seed) for s in range(args.sets) for seed in seeds]
            for which, seed in plan:
                rec = one_run(cell, seed, args.seconds, args.trace)
                rec["set"] = which
                log.write(json.dumps(rec) + "\n")
                log.flush()
                res = rec["result"] or {}
                checks = {k: v["value"] for k, v in
                          res.get("checks", {}).items()}
                metrics = {k: v["value"] for k, v in
                           res.get("metrics", {}).items()}
                print(f"{cell} set {which} seed {seed}: rc {rec['rc']} "
                      f"wall {rec['wall_s']:.1f} s correct "
                      f"{res.get('correct')} checks {checks} metrics "
                      f"{metrics}", flush=True)
                if rec["rc"] != 0 or not res.get("correct"):
                    ok = False
                    print(rec["stderr_tail"][-1500:], flush=True)
                if which >= 0:
                    runs.append(rec)
            for s in range(args.sets):
                got = [r["result"] for r in runs
                       if r["set"] == s and r["result"]]
                names = sorted({k for g in got for k in g["metrics"]})
                for name in names:
                    values = [g["metrics"][name]["value"] for g in got
                              if name in g["metrics"]]
                    med, sp = spread(values)
                    print(f"SPREAD {cell} set {s} {name}: n {len(values)} "
                          f"median {med!r} spread {sp:.5f} values "
                          f"{values}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
