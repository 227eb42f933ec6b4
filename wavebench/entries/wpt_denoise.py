"""``wpt_denoise(x, wavelet, level, per_sample=True)`` with its other
defaults: a Coifman–Wickerhauser best basis a row over SURE costs, the
universal threshold from the row's level-1 details, soft shrinkage of
every basis coefficient but the low-pass packet's, the mixed-level
synthesis; of a (rows, N) float32 batch.

The rows are Donoho and Johnstone's test signals at SNR 7 made on the
device from the seed (:func:`signals`).  The check compares a few seeded
rows of a few sampled batches, the same rows in each, with the float64
reference (``reference/wpt.py:error``): the nearest of the bases that the
float32 tree's rounding leaves open, and how many there are.
"""
from __future__ import annotations

import math
import sys

import torch

import jwave_pro_tpu_torch as jt

from .. import traffic
from ..reference import wpt as ref
from .pool import PoolEntry

# Blocks and Bumps (Donoho and Johnstone, 1994, Table 1; WaveLab's
# MakeSignal): jump or bump positions, heights, and the bumps' widths
POSITIONS = (0.1, 0.13, 0.15, 0.23, 0.25, 0.40, 0.44, 0.65, 0.76, 0.78, 0.81)
BLOCK_HEIGHTS = (4, -5, 3, -4, 5, -4.2, 2.1, 4.3, -3.1, 2.1, -4.2)
BUMP_HEIGHTS = (4, 5, 3, 4, 5, 4.2, 2.1, 4.3, 3.1, 5.1, 4.2)
BUMP_WIDTHS = (0.005, 0.005, 0.006, 0.01, 0.01, 0.03, 0.01, 0.01, 0.005,
               0.008, 0.005)
KINDS = ("blocks", "bumps", "heavisine", "doppler")


def test_signals(n: int, device) -> torch.Tensor:
    """(4, n) float64: Blocks, Bumps, HeaviSine and Doppler at t = i/n,
    i = 1 … n, as WaveLab's ``MakeSignal`` samples them."""
    t = torch.arange(1, n + 1, device=device, dtype=torch.float64) / n
    blocks = torch.zeros_like(t)
    bumps = torch.zeros_like(t)
    for at, jump, height, width in zip(POSITIONS, BLOCK_HEIGHTS,
                                       BUMP_HEIGHTS, BUMP_WIDTHS):
        blocks += jump * (1 + torch.sign(t - at)) / 2
        bumps += height * (1 + ((t - at) / width).abs()) ** -4
    heavisine = (4 * torch.sin(4 * math.pi * t) - torch.sign(t - 0.3)
                 - torch.sign(0.72 - t))
    doppler = torch.sqrt(t * (1 - t)) * torch.sin(2 * math.pi * 1.05
                                                  / (t + 0.05))
    return torch.stack([blocks, bumps, heavisine, doppler])


def signals(spec: dict, rows: int, n: int, gen: torch.Generator, device
            ) -> torch.Tensor:
    """A (rows, n) float32 batch: each row one of the four test signals,
    the kind uniform and a circular shift uniform in [0, n) drawn from
    ``gen``, scaled to a standard deviation of ``sd``, plus Gaussian noise
    of standard deviation ``noise``; made in float64 and rounded once."""
    if spec["kind"] != "donoho_johnstone":
        raise ValueError(f"unknown signal kind {spec['kind']!r}")
    clean = test_signals(n, device)
    clean = clean * (spec["sd"] / clean.std(dim=-1, keepdim=True))
    kind = torch.randint(len(KINDS), (rows, 1), generator=gen, device=device)
    shift = torch.randint(n, (rows, 1), generator=gen, device=device)
    at = (torch.arange(n, device=device) - shift) % n
    noise = torch.randn((rows, n), generator=gen, device=device,
                        dtype=torch.float64)
    return (clean[kind, at] + spec["noise"] * noise).float()


class Entry(PoolEntry):
    CHECK = "wpt_err"

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, dtype: torch.dtype):
        self.configure(config)
        host = traffic.rng(seed)
        gen = traffic.generator(seed, device)
        lengths = traffic.lengths(workload["lengths"], host)
        if set(lengths) != {config["n"]}:
            raise ValueError(f"lengths {sorted(set(lengths))} are not the "
                             f"configuration's {config['n']}")
        self.inputs = [signals(workload["signal"], workload["rows"], n, gen,
                               device) for n in lengths]
        self.args = [x.to(dtype) for x in self.inputs]
        self.samples = [x.numel() for x in self.inputs]
        self.order = traffic.order(len(lengths), workload, host)
        check = workload["check"]
        self.kept = dict.fromkeys(traffic.sample(lengths, check["sample"],
                                                 host))
        # the rows of every sampled batch that the check compares
        self.rows = sorted(host.choice(workload["rows"], check["rows"],
                                       replace=False).tolist())
        self.run(self.args[self.order[0]])
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def configure(self, config):
        if (config["cost"], config["mode"]) != ("sure", "soft"):
            raise ValueError("the reference holds the SURE cost and the "
                             "soft shrink")
        self.wavelet = jt.wavelet(config["wavelet"])
        self.bank = ref.BY_NAME[config["wavelet"]]
        self.level = config["level"]

    def run(self, x):
        return jt.wpt_denoise(x, self.wavelet, self.level, per_sample=True)

    def check(self) -> dict:
        """The largest ``reference/wpt.py:error`` over the sampled answers,
        and the most bases one of their rows allows (NaN where the window
        produced none of them); the most open packets of a row go to
        standard error beside them."""
        found = [ref.error(out[self.rows], self.inputs[i][self.rows],
                           self.bank, self.level)
                 for i, out in self.kept.items() if out is not None]
        if not found:
            return {"wpt_err": math.nan, "wpt_bases": math.nan}
        errs, bases, opened = zip(*found)
        print(f"wpt: open packets of a compared row, at most {max(opened)}",
              file=sys.stderr)
        return {"wpt_err": max(errs), "wpt_bases": max(bases)}
