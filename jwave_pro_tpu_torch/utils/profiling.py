"""Timing on the card (counterpart of ``jwave_pro_tpu/utils/profiling.py``'s
``time_chain``).

PyTorch returns before the device finishes, so a host clock measures the
enqueue; CUDA events recorded on the stream around a run of launches measure
the device.  There is no CPU fallback: a time taken on the host's cores is
not a device time.
"""
from __future__ import annotations

import statistics

import torch

__all__ = ["time_chain"]


def time_chain(step, x, k: int = 10, repeats: int = 5, warmup: int = 2
               ) -> float:
    """Seconds per application of ``step(x)`` on the card.

    ``warmup`` untimed calls, then ``repeats`` timed runs of ``k`` calls
    each between two CUDA events on the current stream; returns the median
    of the per-call times.  ``x`` must be a CUDA tensor.
    """
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise RuntimeError("time_chain times CUDA work; x is not on a CUDA "
                           "device")
    for _ in range(warmup):
        step(x)
    torch.cuda.synchronize(x.device)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            step(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / k)
    return statistics.median(times)
