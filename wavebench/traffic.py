"""The one generator of every cell's inputs, driven by the cell's file.

A cell's file (``workloads/<cell>.json``) gives the rows of a request,
its lengths, the pool of distinct requests and the kind of signal; this
module turns them, with the seed, into the same inputs on every run of
that seed.  Device signals come from a ``torch.Generator`` on the device,
made in a few large calls; host chunks (a sensor feed) from NumPy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1


def rng(seed: int) -> np.random.Generator:
    """The host's random stream of a run."""
    return np.random.default_rng(seed & _SEED_MASK)


def generator(seed: int, device) -> torch.Generator:
    """The device's random stream of a run."""
    return torch.Generator(device=device).manual_seed(seed & _SEED_MASK)


def lengths(spec: dict, host: np.random.Generator) -> list[int]:
    """The signal length of each request in the pool.

    ``{"kind": "fixed", "n": N, "count": C}``: C requests of N samples.
    ``{"kind": "log_uniform_quantiles", "count": C, "low": a, "high": b,
    "jitter": j}``: the C midpoint quantiles of a log-uniform distribution
    over [a, b], each moved by a seeded whole number in [−j, j] and off a
    power of two.  Every seed gets the same distribution of lengths, so the
    tail of the latencies rests on the same sizes; only the data and the
    order change.
    """
    kind = spec["kind"]
    if kind == "fixed":
        return [int(spec["n"])] * int(spec.get("count", 1))
    if kind == "log_uniform_quantiles":
        count = int(spec["count"])
        lo, hi = math.log(spec["low"]), math.log(spec["high"])
        q = np.exp(lo + (np.arange(count) + 0.5) / count * (hi - lo))
        jitter = int(spec.get("jitter", 0))
        moved = np.rint(q).astype(np.int64) + host.integers(
            -jitter, jitter + 1, size=count)
        out = []
        for n in moved.tolist():
            if n & (n - 1) == 0:
                n += 1
            out.append(int(n))
        return out
    raise ValueError(f"unknown length kind {kind!r}")


def order(count: int, spec: dict, host: np.random.Generator) -> list[int]:
    """The order in which a run cycles through the pool: as made, or a
    seeded permutation (``"shuffle": true``)."""
    if spec.get("shuffle"):
        return host.permutation(count).tolist()
    return list(range(count))


def sample(lengths: list[int], k: int, host: np.random.Generator
           ) -> list[int]:
    """``k`` pool indexes whose answers the check compares: the requests
    at ``k`` evenly spaced ranks of length, the longest among them, ties
    broken by the seed.  Every seed so keeps answers of the same sizes
    (the same memory), while which request, its data and its place in the
    order come from the seed."""
    key = host.permutation(len(lengths))
    by_length = sorted(range(len(lengths)),
                       key=lambda i: (lengths[i], key[i]), reverse=True)
    k = min(k, len(lengths))
    return sorted(by_length[(r * len(lengths)) // k] for r in range(k))


def signal(spec: dict, rows: int, n: int, gen: torch.Generator,
           device) -> torch.Tensor:
    """A (rows, n) float32 batch on ``device``.

    ``gaussian``: unit normal samples.  ``chirp``: a linear chirp per row,
    its start and end frequencies (cycles per sample) uniform in
    ``f0`` and ``f1``, plus Gaussian noise of standard deviation
    ``noise``.  ``tones``: ``tones`` sinusoids per row at frequencies
    uniform in ``freq`` and amplitudes uniform in [0.5, 1.5], plus noise.
    """
    kind = spec["kind"]
    noise = torch.randn((rows, n), generator=gen, device=device)
    if kind == "gaussian":
        return noise
    t = torch.arange(n, device=device, dtype=torch.float64)

    def uniform(lo_hi, shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device,
                                           dtype=torch.float64)

    if kind == "chirp":
        f0 = uniform(spec["f0"], (rows, 1))
        f1 = uniform(spec["f1"], (rows, 1))
        phase = 2 * math.pi * (f0 * t + (f1 - f0) * t * t / (2 * n))
        clean = torch.sin(phase)
    elif kind == "tones":
        k = int(spec["tones"])
        freq = uniform(spec["freq"], (rows, k, 1))
        amp = uniform((0.5, 1.5), (rows, k, 1))
        shift = uniform((0.0, 2 * math.pi), (rows, k, 1))
        clean = (amp * torch.sin(2 * math.pi * freq * t + shift)).sum(1)
    else:
        raise ValueError(f"unknown signal kind {kind!r}")
    return (clean + spec["noise"] * noise.double()).float()


def host_chunks(count: int, n: int, host: np.random.Generator) -> np.ndarray:
    """(count, n) float32 host samples, one row a chunk of a sensor feed."""
    return host.standard_normal((count, n), dtype=np.float32)
