"""The two readings each check's limit is set from, in one process.

    python wavebench/control.py --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 21,22,23 [--seconds 2]

For every seed of ``--seeds`` it makes the cell's inputs, runs the timed
path for a short window at the cell's own sizes and load, and reads the
check's number: the largest of these is the lower reading.  For every
seed of ``--control-seeds`` it does the same with the control: the
program's own bfloat16 path, the precision below the configuration's
float32, on the same inputs rounded to it, against the same float64
reference.  The smallest of those is the upper reading.  A limit lies
between the two.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CONTROL = torch.bfloat16


def reading(cell, seed: int, seconds: float, dtype: torch.dtype,
            device="cuda") -> dict:
    """The check's numbers of one short window of ``cell`` at ``dtype``."""
    from wavebench import core

    device = torch.device(device)
    entry = core.make_entry(cell, seed, device, dtype)
    win = core.Driver(entry, cell.workload["loop"], device).measure(seconds)
    entry.release()
    found = entry.check()
    del entry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "dtype": str(dtype), "calls": win.calls,
            "failed": win.failed, **found}


def main(argv=None) -> int:
    from wavebench import core

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    limits = cell.workload["check"]["limits"]
    got = {}
    for dtype, seeds in ((torch.float32, args.seeds),
                         (CONTROL, args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",")):
            r = reading(cell, seed, args.seconds, dtype)
            print(json.dumps(r), flush=True)
            for name in limits:
                got.setdefault((name, str(dtype)), []).append(r[name])
    for name, limit in limits.items():
        lower = max(got[(name, str(torch.float32))])
        upper = min(got[(name, str(CONTROL))])
        print(f"READING {cell.name} {name}: lower {lower!r} upper "
              f"{upper!r} ratio {upper / lower:.1f} limit {limit!r} "
              f"control fails {upper > limit} sound passes "
              f"{lower <= limit}", flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
