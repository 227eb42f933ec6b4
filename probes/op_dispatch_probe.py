"""Host time of one call through a ``torch.library`` operator, two ways.

    python3 probes/op_dispatch_probe.py

Times, in µs a call (host clock, 20,000 calls a run, median of 5), an
operator with the kernel operators' schema (a tensor, two float lists, an
int; its body allocates a one-element output and does nothing else)
called three ways: as a ``torch.library.custom_op``, as an operator
defined with ``torch.library.Library`` and one backend kernel (the route
the package's kernel operators take, ``kernels/_launch.py:kernel_op``),
and as the body itself.  On a machine with a card the tensors lie on it;
every line names their device.
"""
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jwave_pro_tpu_torch as jt  # noqa: E402
from jwave_pro_tpu_torch.kernels import _launch as kl  # noqa: E402


def per_call(fn, calls: int = 20_000, runs: int = 5) -> float:
    for _ in range(min(calls, 200)):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


def body(x: torch.Tensor, g: list[float], h: list[float],
         level: int) -> torch.Tensor:
    return torch.empty(1, device=x.device)


def main() -> None:
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    where = torch.cuda.get_device_name(0) if dev.type == "cuda" else "CPU"

    probe = torch.library.custom_op("jwprobe::launch", mutates_args=())(
        body)
    probe.register_fake(lambda x, g, h, level: x.new_empty(1))
    lib = torch.library.Library("jwprobe2", "DEF")
    lib.define("launch(Tensor x, float[] g, float[] h, int level) -> Tensor")
    lib.impl("launch", body, "CUDA" if dev.type == "cuda" else "CPU")

    x = torch.ones(3, device=dev)
    g, h = kl.op_taps(jt.wavelet("Daubechies 4"))
    plain = torch.ops.jwprobe2.launch.default
    for name, fn in (("custom_op", lambda: probe(x, g, h, 5)),
                     ("Library.impl", lambda: plain(x, g, h, 5)),
                     ("body", lambda: body(x, g, h, 5))):
        print(f"{name}: {per_call(fn):.2f} µs a call (host clock, "
              f"tensors on {where})", flush=True)


if __name__ == "__main__":
    main()
