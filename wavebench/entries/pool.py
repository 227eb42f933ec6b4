"""An entry over a pool of distinct requests, each a (rows, n) float32
batch on the device, made from the seed as the cell's file says.

A subclass names the program's call (``run``) and the reference's
verdict on one answer (``error``).  The answers of a sample of the pool
(``traffic.sample``) are kept as the window produces them (the last
answer to each sampled request), and compared once the window has closed.
"""
from __future__ import annotations

import torch

from .. import traffic


class PoolEntry:
    CHECK = ""        # the name of the number the check compares

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, dtype: torch.dtype):
        self.configure(config)
        host = traffic.rng(seed)
        gen = traffic.generator(seed, device)
        lengths = traffic.lengths(workload["lengths"], host)
        self.inputs = [traffic.signal(workload["signal"], workload["rows"],
                                      n, gen, device) for n in lengths]
        # the program's operands: the inputs themselves at float32, a
        # rounded copy for the lower-precision control
        self.args = [x.to(dtype) for x in self.inputs]
        self.samples = [x.numel() for x in self.inputs]
        self.order = traffic.order(len(lengths), workload, host)
        self.kept = dict.fromkeys(traffic.sample(
            lengths, workload["check"]["sample"], host))
        warmed = set()
        for i in self.order:
            if lengths[i] not in warmed:
                self.run(self.args[i])
                warmed.add(lengths[i])
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def configure(self, config: dict) -> None:
        raise NotImplementedError

    def run(self, x: torch.Tensor):
        raise NotImplementedError

    def error(self, x: torch.Tensor, out) -> float:
        raise NotImplementedError

    def call(self, i: int):
        out = self.run(self.args[i])
        if i in self.kept:
            self.kept[i] = out
        return out

    def release(self) -> None:
        """Free the program's operands, keeping the sampled inputs."""
        self.args = None
        self.inputs = {i: self.inputs[i] for i in self.kept}

    def check(self) -> dict:
        """The largest error over the sampled answers (NaN where the window
        produced none of them)."""
        errs = [self.error(self.inputs[i], out)
                for i, out in self.kept.items() if out is not None]
        return {self.CHECK: max(errs) if errs else float("nan")}
