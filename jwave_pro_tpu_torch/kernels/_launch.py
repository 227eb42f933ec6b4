"""The launch layer every kernel module shares; it knows no kernel.

A launcher's operator body is four steps: check its operands
(:func:`check_operand`, :func:`check_taps`), take its plan, allocate its
outputs, and :func:`launch` the C entry point, whose signature
``_build.SIGNATURES`` declares.  :func:`kernel_op` makes the body the
operator ``jwave::<name>``, counts its launches in :data:`LAUNCHES` and
opens the span ``jwave.launch.<name>`` around each.  Beside them: the
dtypes the kernels read and write (:data:`DTYPE_CODES`), the forms the
taps travel in (:func:`op_taps`, :func:`host_taps`), and the zeroed
device buffers that kernels finishing a reduction inside their launch
keep per stream (:func:`zeroed`, :func:`tickets`).
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..ops.modwt import modwt_base_filters
from ..utils.device import tracing
from ..utils.profiling import spanned
from ..wavelets.base import DiscreteWavelet
from . import _build

__all__ = [
    "MAX_TAPS", "SMEM_LIMIT", "DTYPE_CODES", "LAUNCHES", "kernel_op",
    "launch", "check_operand", "check_threshold", "check_grid",
    "check_taps", "check_device",
    "compute_dtype", "kernel_taps", "op_taps", "host_taps", "zeroed",
    "tickets", "sm_count",
]

MAX_TAPS = 64                 # JW_MAX_TAPS in csrc/common.cuh
SMEM_LIMIT = 232_448          # shared memory one H100 block may use (227 KB)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # JwDtype


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: float64 for float64,
    float32 for the rest."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def check_operand(t: torch.Tensor, name: str, ndim: int,
                  traced: bool = False, dtypes=DTYPE_CODES) -> None:
    """Raise unless ``t`` is what the kernels take: a contiguous CUDA
    tensor of ``ndim`` dims and one of ``dtypes``.  ``traced``: the check
    an operator's fake makes, on a traced or ``meta`` tensor, leaves out
    the device and the strides (which may be symbolic there); the launch
    checks both on the concrete tensor."""
    if not (traced or t.is_cuda):
        raise ValueError(f"{name}: kernel needs a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        takes = "/".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name}: kernel takes {takes}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not (traced or t.is_contiguous()):
        raise ValueError(f"{name}: kernel needs a contiguous tensor")


def check_threshold(threshold: torch.Tensor, x: torch.Tensor,
                    traced: bool = False) -> None:
    """Raise unless ``threshold`` is one float32 threshold a row of ``x``
    (B, ...), as the fused denoise kernels take it; ``traced`` as in
    :func:`check_operand`."""
    if (threshold.dtype != torch.float32 or threshold.ndim != 1
            or not traced and (threshold.shape[0] != x.shape[0]
                               or threshold.device != x.device
                               or not threshold.is_contiguous())):
        raise ValueError("threshold: kernel needs a contiguous (B,) float32 "
                         "tensor on x's device")


def check_grid(batch: int, n: int, tile: int) -> None:
    """Raise unless ``batch`` rows of ``n`` in tiles of ``tile`` fit the
    kernels' grid."""
    if -(-n // tile) * batch >= 2 ** 31:
        raise ValueError(f"{batch}×{n} exceeds the kernel grid")


def check_taps(g, h) -> int:
    """Raise unless (g, h) is a filter pair the kernels take; its length."""
    if len(g) != len(h) or not 1 <= len(g) <= MAX_TAPS:
        raise ValueError(f"taps: need two filters of equal length in "
                         f"[1, {MAX_TAPS}], got {len(g)} and {len(h)}")
    return len(g)


def check_device(a: torch.Tensor, what: str) -> None:
    """Raise unless a kernel without a backward may take ``a``: a CUDA
    tensor that needs no gradient, or a CPU tensor (its plain version)."""
    if a.is_cuda:
        if a.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"the {what} kernel has no backward; use "
                             f"method='direct' for a differentiable call")
    elif a.device.type != "cpu":
        raise ValueError(f"no {what} kernel for device {a.device}")


@functools.lru_cache(maxsize=64)
def kernel_taps(wavelet: DiscreteWavelet):
    """(g̃, h̃) as contiguous float32 host arrays, as the kernels take them."""
    return tuple(np.ascontiguousarray(f, dtype=np.float32)
                 for f in modwt_base_filters(wavelet))


@functools.lru_cache(maxsize=64)
def _op_taps(wavelet: DiscreteWavelet) -> tuple:
    return tuple(tuple(f.tolist()) for f in kernel_taps(wavelet))


def op_taps(wavelet: DiscreteWavelet) -> tuple[list[float], list[float]]:
    """(g̃, h̃) as the kernel operators take them: the float32 taps of
    :func:`kernel_taps` as lists of Python floats (each exact), so an
    exported graph carries them as constants and a wavelet built from
    custom taps exports too."""
    return tuple(list(f) for f in _op_taps(wavelet))


@functools.lru_cache(maxsize=64)
def _host_taps(g: tuple, h: tuple):
    return tuple(np.ascontiguousarray(f, dtype=np.float32) for f in (g, h))


def host_taps(g, h):
    """The operators' tap lists back as the contiguous float32 host arrays
    the C entry points read (cached)."""
    return _host_taps(tuple(g), tuple(h))


_ZEROED: dict = {}


def zeroed(name: str, device: torch.device, stream: int, count: int) -> int:
    """Address of int32 zeros that the kernels using them leave zero when
    a launch ends: one buffer per (``name``, device, stream), at least
    ``count`` long.  Launches on one stream run in order, and two streams
    never share a buffer.  ``stream``: the CUDA stream handle the kernel
    runs on (the current stream's ``cuda_stream``)."""
    key = (name, device.index, stream)
    buf = _ZEROED.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 256), dtype=torch.int32, device=device)
        _ZEROED[key] = buf
    return buf.data_ptr()


def tickets(device: torch.device, stream: int, rows: int) -> int:
    """Address of the per-row ticket counters of the kernels that finish
    their cross-tile reduction inside the launch ('var', 'select', the
    median): :func:`zeroed`, at least ``rows`` long.  The row's last block
    resets its ticket."""
    return zeroed("tickets", device, stream, rows)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(entry: str, what: str, device: torch.device, *args,
           stream: int | None = None) -> None:
    """Call the C entry point ``entry`` with ``args``, then the device's
    index and the stream handle (``stream``, default the device's current
    stream); raise with ``what`` if it returns a CUDA error."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    lib = _build.library()
    _build.check(lib, getattr(lib, entry)(*args, device.index, stream), what)


# The launchers' operators.  Each is defined on this library with its
# launch as the one kernel for CPU and CUDA tensors (a CPU tensor raises in
# the launch) and a fake.  The dispatcher's host time (a sixth of a
# ``torch.library.custom_op``'s, ``probes/op_dispatch_probe.py``) is paid
# only where a graph needs the operator: while torch traces, and in a
# served graph.
_OPS = torch.library.Library("jwave", "FRAGMENT")


#: Kernel launches by operator name (``LAUNCHES["modwt_fwd"]``), eager and
#: served alike: each is counted where :func:`kernel_op` launches it.
LAUNCHES: collections.Counter = collections.Counter()


def kernel_op(name: str):
    """Decorator: define the operator ``jwave::<name>``, its schema the
    decorated launch's signature, with the launch as its kernel; return
    the launchers' entry to it.  The entry calls the operator while torch
    traces, so the trace records one node that launches the kernel when
    served, and the launch itself otherwise: the same kernel, without the
    dispatcher's host time on every eager launch.  Either way the launch
    runs inside the span ``jwave.launch.<name>`` and, once it returns,
    counts in ``LAUNCHES[name]``.  The entry has ``register_fake``, the
    decorator that sets the operator's fake (what ``meta`` tensors and
    ``torch.export`` run)."""
    def define(body):
        _OPS.define(name + torch.library.infer_schema(body, mutates_args=()))
        @spanned("jwave.launch." + name)
        @functools.wraps(body)
        def counted(*args):
            out = body(*args)
            LAUNCHES[name] += 1
            return out

        for key in ("CPU", "CUDA"):
            _OPS.impl(name, counted, key)
        op = getattr(torch.ops.jwave, name).default

        @functools.wraps(body)
        def call(*args):
            return op(*args) if tracing() else counted(*args)

        call.register_fake = torch.library.register_fake(
            f"jwave::{name}", lib=_OPS)
        return call
    return define
