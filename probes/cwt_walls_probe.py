"""Walls of the default ``cwt`` at five shapes, for comparing two trees.

    python3 probes/cwt_walls_probe.py [ROOT]

Imports ``jwave_pro_tpu_torch`` from ROOT (default: this checkout), builds
its kernels there, and prints one JSON line: for each shape, the
host-clock wall in ms of ``cwt(x, scales, MorletWavelet.from_omega0(6))``
with the default method (median of 3 calls, each ending in a synchronize,
after one warm call), the median of 11 such calls, the launches of the
CWT kernel a call and the call's peak of allocated device memory above
what was allocated before it; with the card's name and power limit.
Shapes: (64, 16384) S = 64 (the CWT cell's), (16, 4096) S = 64
(``bench.py``'s), (4, 3000) S = 11, (1, 64) S = 8 and (8, 2²⁰) S = 64, whose
padded length passes what the kernel takes.  Each number depends on the
host's load, so two trees are compared only within one machine session,
run alternately (parent, change, change, parent).
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

import jwave_pro_tpu_torch as jt  # noqa: E402
from jwave_pro_tpu_torch.kernels._launch import LAUNCHES  # noqa: E402

# (rows, n, scales, the largest scale of the log-spaced grid from 1)
SHAPES = ((64, 16384, 64, 256.0), (16, 4096, 64, 256.0),
          (4, 3000, 11, 64.0), (1, 64, 8, 16.0), (8, 1 << 20, 64, 256.0))


def walls_ms(fn, repeats: int) -> list:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main() -> None:
    assert Path(jt.__file__).resolve().is_relative_to(ROOT), jt.__file__
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    wav = jt.MorletWavelet.from_omega0(6.0)
    out = {"root": str(ROOT), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "shapes": {}}
    for rows, n, s, top in SHAPES:
        x = torch.from_numpy(rng.standard_normal((rows, n)).astype(
            np.float32)).to(dev)
        scales = jt.generate_log_scales(1.0, top, s)

        def call():
            return jt.cwt(x, scales, wav).coefficients

        call()
        torch.cuda.synchronize()
        before = LAUNCHES["cwt_ifft"]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = LAUNCHES["cwt_ifft"] - before
        three = walls_ms(call, 3)
        eleven = walls_ms(call, 11)
        out["shapes"][f"({rows}, {n}) S={s}"] = {
            "ms_median_of_3": statistics.median(three),
            "ms_median_of_11": statistics.median(eleven),
            "cwt_ifft_launches": launches, "peak_mib": peak / 2 ** 20}
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
