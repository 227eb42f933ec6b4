"""``StreamingMODWT.update(chunk)``: many channels, each its own stream
with the incremental strategy, served round-robin with host chunks.

A sensor feed lands in host memory, so every chunk is a host float32
NumPy array, which ``update`` moves to the card itself.  The chunks come
from a seeded host pool: update k of channel c takes pool row
(c·STRIDE + k) mod size, so the check can rebuild every channel's
history.  Set-up fills each buffer, and the halo before it, so every
measured update is in steady state.  The check holds each channel's last
answer, its whole (level + 1, buffer) coefficient matrix, against the
causal MODWT of its history.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch import streaming

from .. import traffic
from ..reference import compare, filters
from ..reference import modwt as ref

STRIDE = 16


class Entry:
    CHECK = "stream_err"

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, dtype: torch.dtype):
        self.filters = filters.BY_NAME[config["wavelet"]]
        self.level = config["level"]
        self.buffer = workload["buffer"]
        chunk = workload["lengths"]["n"]
        channels = workload["rows"]
        self.device = device
        self.chunks = traffic.host_chunks(workload["host_pool"], chunk,
                                          traffic.rng(seed))
        halo = (len(self.filters[0]) - 1) * ((1 << self.level) - 1)
        self.history = math.ceil((self.buffer + halo) / chunk)
        cfg = streaming.StreamingConfig(
            buffer_size=self.buffer, max_level=self.level,
            update_strategy=streaming.UpdateStrategy.INCREMENTAL,
            dtype=dtype, device=device)
        wavelet = jt.wavelet(config["wavelet"])
        self.streams = [streaming.StreamingMODWT(wavelet, cfg)
                        for _ in range(channels)]
        self.updates = [0] * channels
        self.last = [None] * channels
        self.order = list(range(channels))
        self.samples = [chunk] * channels
        for _ in range(self.history):
            for c in self.order:
                self.call(c)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _chunk(self, c: int, k: int) -> np.ndarray:
        return self.chunks[(c * STRIDE + k) % len(self.chunks)]

    def call(self, c: int):
        out = self.streams[c].update(self._chunk(c, self.updates[c]))
        self.updates[c] += 1
        self.last[c] = out
        return out

    def release(self) -> None:
        self.streams = None

    def check(self) -> dict:
        errs = []
        for c, out in enumerate(self.last):
            k = self.updates[c]
            history = torch.from_numpy(np.concatenate(
                [self._chunk(c, j) for j in range(k - self.history, k)]))
            want = ref.causal_tail(history.to(self.device), self.filters,
                                   self.level, self.buffer)
            errs.append(compare.rel_err(out, want))
        return {self.CHECK: max(errs)}
