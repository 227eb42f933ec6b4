"""Profiling helpers (counterpart of ``jwave_pro_tpu/utils/profiling.py``):
the chained samples/s measurement ``bench.py`` defines its throughputs by,
and a ``torch.profiler`` trace context."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from .device import as_input

__all__ = ["time_chain", "measure_samples_per_sec", "trace"]


def _chain(step, x, k):
    """``k`` chained steps, ended by a small reduction of the last output
    (JAX ``utils/profiling.py:33-35``)."""
    v = x
    for _ in range(k):
        v = step(v)
    return v.reshape(-1)[:16].sum()


def _timed_chain(step, x, k) -> float:
    """Seconds of one chain of ``k`` steps, its end read back to the host.

    On a CUDA tensor: CUDA events on the tensor's current stream around the
    chain, after a synchronise, so the time is the device's.  On a CPU
    tensor (the caller asked for the CPU): ``time.perf_counter``, as the
    JAX package's time is on a CPU backend.
    """
    if x.is_cuda:
        stream = torch.cuda.current_stream(x.device)
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = _chain(step, x, k)
        end.record(stream)
        float(out)
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(_chain(step, x, k))
    return time.perf_counter() - t0


def time_chain(step, x, k_short=4, k_long=24, repeats=5):
    """Seconds per application of ``step`` (a shape-preserving fn of x).

    Mirrors JAX ``utils/profiling.py:15-53``: the chain feeds each output
    back as the next input (``v = step(v)``), so iterations are serialised
    through a data dependence, and differencing a short and a long chain,
    (t_long − t_short)/(k_long − k_short), cancels the fixed cost of
    starting a chain and reading its end back.  One untimed run of each
    chain comes first (JAX's two compile calls, ``:39-40``; here they build
    the kernels and fill the caches).  A stall during the short run drives
    a repeat's difference toward zero or below, so the estimate is the
    upper median of the positive differences, 1e-9 when none is positive
    and never below it (``:45-53``).
    """
    x = as_input(x)
    float(_chain(step, x, k_short))
    float(_chain(step, x, k_long))
    diffs = []
    for _ in range(repeats):
        t_s = _timed_chain(step, x, k_short)
        t_l = _timed_chain(step, x, k_long)
        diffs.append((t_l - t_s) / (k_long - k_short))
    pos = sorted(d for d in diffs if d > 0)
    if not pos:  # every repeat corrupted by timing noise
        return 1e-9
    return max(pos[len(pos) // 2], 1e-9)


def measure_samples_per_sec(step, x, k_short=4, k_long=24, repeats=3):
    """Throughput of ``step`` (shape-preserving fn) in samples/s: the
    elements of ``x`` over :func:`time_chain` (JAX ``:56-62``)."""
    x = as_input(x)
    return x.numel() / time_chain(step, x, k_short, k_long, repeats)


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(), "torch-trace")):
    """``torch.profiler`` trace context (JAX ``:65-72``): CPU activity, and
    CUDA activity where torch sees a card, written under ``logdir`` as one
    ``*.pt.trace.json`` file by ``tensorboard_trace_handler`` (open it in
    TensorBoard's profiler plugin or in Perfetto).  The default directory
    lies in the process's temporary directory (``TMPDIR``), where JAX's is
    ``/tmp/jax-trace``.  Yields ``logdir``; the profiler stops, and the
    trace is written, when the block ends, also when it raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            os.fspath(logdir)))
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
