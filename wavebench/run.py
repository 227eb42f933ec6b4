"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python wavebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` runs a
traced window after the measured one and prints its per-layer metrics.
Every run checks its answers against the plain reference and prints each
number compared beside its limit, last on standard error and last in the
result line.  Without a CUDA card, or with JAX loaded, it prints no
result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every cache a library may keep lives at a fixed path in the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, sub in CACHES.items():
        os.environ[key] = str(ROOT / "build" / "wavebench" / sub)
    # the program's work is on the card: one thread for the host
    # libraries' loops keeps their workers off the launching thread's cores
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"

    import torch

    from wavebench import core

    cell = core.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"wavebench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 2
    result = core.run(cell, args.seed, args.seconds, bool(args.trace))
    leaked = core.forbidden_modules()
    if leaked:
        print(f"wavebench: the run loaded {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    if result.get("first_failure"):
        print(result["first_failure"], file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
