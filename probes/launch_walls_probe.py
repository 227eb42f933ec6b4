"""Walls of the port's launch-bound paths, for comparing two trees.

    python3 probes/launch_walls_probe.py [ROOT]

Imports ``jwave_pro_tpu_torch`` from ROOT (default: this checkout), builds
its kernels there, and prints one JSON line: the host-clock wall in ms
(median of 11 calls, each ending in a synchronize) of matching pursuit
and OMP at (8, 65536) Db4 L3 K = 16 (the select kernel's path), one
incremental ``StreamingMODWT.update`` of 4096 samples (buffer 16384, L5),
``_causal_tail`` at (64, 4313) and ``modwt_chunked`` over (64, 2²⁰) in
chunks of 4096 (the shapes of ``chip_smoke.py``'s phases 14 and 28), and
the host µs one forward-kernel launch costs at (1, 4096) L5 through its
launcher (200 launches between synchronizes, median of 5); with the card's
name and power limit.  Each number depends on the host's load, so two
trees are compared only within one machine session, run alternately
(parent, change, change, parent).
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
from jwave_pro_tpu_torch import streaming as st  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc  # noqa: E402


def wall_ms(fn, repeats: int = 11) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launch_us(fn, launches: int = 200, runs: int = 5) -> float:
    for _ in range(20):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / launches * 1e6)
    return statistics.median(times)


def main() -> None:
    assert Path(jt.__file__).resolve().is_relative_to(ROOT), jt.__file__
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def signal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    w = jt.wavelet("Daubechies 4")
    level, chunk, buf = 5, 4096, 16384
    halo = (w.length - 1) * ((1 << level) - 1)
    xm = signal(8, 65536)
    window = signal(64, halo + chunk)
    sig = signal(16 * chunk)
    sm = st.StreamingMODWT(w, st.StreamingConfig(buf, level, device=dev))
    for i in range(16):
        sm.update(sig[i * chunk:(i + 1) * chunk])
    piece = sig[:chunk]
    xc = signal(64, 1 << 20)
    v = signal(1, 4096)
    calls = {
        "MP (8, 65536) L3 K16": lambda: jt.matching_pursuit(
            xm, w, 3, 16, method="auto", orthogonalize=False),
        "OMP (8, 65536) L3 K16": lambda: jt.matching_pursuit(
            xm, w, 3, 16, method="auto", orthogonalize=True),
        "StreamingMODWT.update incremental (4096,)":
            lambda: sm.update(piece),
        f"_causal_tail {tuple(window.shape)}":
            lambda: st._causal_tail(window, chunk, w, level),
        "modwt_chunked (64, 1048576) in chunks of 4096":
            lambda: list(st.modwt_chunked(xc.split(chunk, dim=-1), w,
                                          level)),
    }
    out = {"root": str(ROOT), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    out["ms"] = {name: wall_ms(fn) for name, fn in calls.items()}
    out["launch_us (1, 4096) L5"] = launch_us(
        lambda: kc.modwt_fwd_cuda(v, w, level))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
