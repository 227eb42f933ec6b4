"""Fused multi-level MODWT kernels for the H100 (``csrc/modwt.cu``).

Replaces ``jwave_pro_tpu/kernels/modwt_pallas.py``:

* ``jw_modwt_fwd_kernel`` ← ``_forward_kernel`` (``:204``) and
  ``_forward_kernel_flat`` (``:286``).  The flat variant exists only for the
  TPU's sublane layout; here a 1D ``(N,)`` input is B = 1 of the batched
  kernel, and ``(L+1, 1, N) → (L+1, N)`` is a free view.
* ``jw_modwt_inv_kernel`` ← ``_inverse_kernel`` (``:564``).

What bounds them on the H100 is device-memory traffic: the forward moves
1 read + (L+1) writes per sample against 4·M·L flops, the inverse the
mirror image.  Each block keeps one tile's whole level chain in shared
memory and reads its circular context ``x[(p) mod N]`` directly, so any N
runs without padding, folding or a tile plan; the only limit is the
shared-memory budget (:func:`kernel_supported`).  Both are templated on
the filter length (taps as parameter-bank operands) and compute each
level in register chains of ``CHAIN[kind]`` outputs a thread.  The
forward stages each warp's W outputs in shared memory so that its stores,
L + 1 rows for each row read, stay coalesced; the inverse has the next
level's W row in flight while a level runs.

Beside each kernel: its plain PyTorch version (``modwt_fwd_plain``,
``modwt_inv_plain``), which the CPU path runs and the chip smoke compares
against, and a launch count (``LAUNCHES["modwt_fwd"]``,
``LAUNCHES["modwt_inv"]``).  Each launch is a ``torch.library`` operator
(``jwave::modwt_fwd``, ``jwave::modwt_inv``) whose taps travel as float
lists (:func:`op_taps`) and whose grid is planned at launch, so a
batch-polymorphic ``torch.export`` records the launch and the served graph
runs the kernel; its fake gives the output's shape.  bfloat16 tensors are
read and written as bfloat16 and computed in float32, in the kernels and
their plain versions alike.  The autograd pair (:func:`modwt_fused`,
:func:`imodwt_fused`) rests on Aᵀ = A⁻¹ for the analysis operator A: each
direction's backward is the other kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.modwt import (
    _check_level, _combined_adjoint, _conv_channels, modwt_base_filters,
    taps_as,
)
from ..utils.device import tracing
from ..utils.profiling import spanned
from ..wavelets.base import DiscreteWavelet
from . import _build

__all__ = [
    "modwt_fused", "imodwt_fused", "kernel_supported",
    "modwt_fwd_cuda", "modwt_inv_cuda", "modwt_fwd_plain", "modwt_inv_plain",
    "modwt_fwd_op", "modwt_inv_op", "op_taps", "kernel_op", "LAUNCHES",
]

MAX_TAPS = 64                 # JW_MAX_TAPS in csrc/common.cuh
WARPS = 512 // 32             # JW_THREADS / 32 in csrc/common.cuh
SMEM_LIMIT = 232_448          # shared memory one H100 block may use (227 KB)
# outputs per block; the packet kernels ('pfwd', 'select', 'pinv') keep
# 2L - 1 or 2L window rows, hence the smaller tile of two (the select's and
# both forwards' are cut where their rows do not fit: :func:`tile_of`)
TILES = {"fwd": 4096, "inv": 4096, "denoise": 2048, "var": 4096,
         "pfwd": 2048, "select": 4096, "pinv": 2048}
# outputs in one thread's register chain: JW_VAR_R (csrc/variance.cu),
# JW_SELECT_R, JW_PFWD_R and JW_PINV_R (csrc/modwpt.cu), JW_FWD_R and
# JW_INV_R (csrc/modwt.cu) and JW_DENOISE_R (csrc/denoise.cu, both its
# analysis and its synthesis chains); odd, so a warp's loads hit 32 banks
CHAIN = {"var": 9, "select": 5, "fwd": 9, "inv": 7, "denoise": 5,
         "pfwd": 5, "pinv": 5}
FWD_THREADS = 256             # JW_FWD_THREADS in csrc/modwt.cu
PFWD_THREADS = 256            # JW_PFWD_THREADS in csrc/modwpt.cu
# the forwards' output staging, floats a block: a slice of 32 chains'
# outputs a warp, W_j for 'fwd' (JW_FWD_SLICE), both leaves for 'pfwd'
# (JW_PFWD_SLICE)
FWD_SLICE = FWD_THREADS * CHAIN["fwd"]
PFWD_SLICE = PFWD_THREADS * 2 * CHAIN["pfwd"]
SLICES = {"fwd": FWD_SLICE, "pfwd": PFWD_SLICE}
# the slice is paid for out of the forward's tile, not its halo: the tile is
# cut to what the slice leaves of the budget (:func:`tile_of`), and a shape
# runs only where that leaves this much, i.e. where its halo fits beside a
# full tile in two rows without the slice
FWD_MIN_TILE = TILES["fwd"] - FWD_SLICE // 2
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # JwDtype

_P, _I = ctypes.c_void_p, ctypes.c_int


def halo(m: int, level: int) -> int:
    """Exact context one output needs: (M−1)(2^L − 1) samples."""
    return (m - 1) * ((1 << level) - 1)


def _rows(kind: str, level: int) -> int:
    """Window rows of the packet kernels' depth-first walk: 2L − 1 for the
    forward and the select, 2L for the inverse (three at L = 1, where the
    root needs a row of its own)."""
    return {"pfwd": 2 * level - 1, "select": 2 * level - 1,
            "pinv": max(2 * level, 3)}[kind]


def tile_of(kind: str, level: int, m: int) -> int:
    """Outputs per block of kernel ``kind``: ``TILES[kind]``, the select's
    and both forwards' cut to what their rows (2L − 1 for the select and
    the packet forward, two for the MODWT forward, the forwards' beside
    their staging slices) leave of the shared-memory budget (below 1 where
    even the halo does not fit)."""
    free = SMEM_LIMIT // 4 - 2 * MAX_TAPS
    if kind == "select":
        fit = (free - 8 * WARPS) // _rows(kind, level) - halo(m, level)
    elif kind == "pfwd":
        fit = (free - PFWD_SLICE) // _rows(kind, level) - halo(m, level)
    elif kind == "fwd":
        fit = (free - FWD_SLICE) // 2 - halo(m, level)
    else:
        return TILES[kind]
    return min(TILES[kind], fit)


def smem_bytes(level: int, m: int, kind: str, tile: int | None = None,
               slice_floats: int | None = None) -> int:
    """Dynamic shared memory of one block: the taps plus the window rows
    (two V buffers for 'fwd', with one W staging slice a warp; for 'var'
    two V buffers, with one warp sum a warp
    and level; two V and one W for 'inv'; two V and L W rows over a
    two-sided window for 'denoise'; the depth-first packet path's 2L − 1
    rows for 'pfwd', with one slice of both leaves a warp, and for
    'select', which adds two sets of two leaves' 64-bit arg-max keys per
    warp; 2L rows for 'pinv', three at L = 1).  ``tile`` (default
    :func:`tile_of`) and ``slice_floats`` (floats of a forward's staging
    slices, default ``SLICES[kind]``) lay out another plan, as a probe's
    variant of a kernel runs it."""
    h, t = halo(m, level), tile or tile_of(kind, level, m)
    sl = SLICES.get(kind, 0) if slice_floats is None else slice_floats
    rows = {"fwd": sl + 2 * (t + h), "inv": 3 * (t + h),
            "denoise": (level + 2) * (t + 2 * h),
            "var": 2 * (t + h) + WARPS * (level + 1),
            "pfwd": sl + _rows("pfwd", level) * (t + h),
            "select": _rows("select", level) * (t + h) + 8 * WARPS,
            "pinv": _rows("pinv", level) * (t + h)}[kind]
    return 4 * (2 * MAX_TAPS + rows)


def kernel_supported(n: int, level: int, m: int, kind: str) -> bool:
    """Whether kernel ``kind`` runs this shape: 'fwd', 'inv', 'denoise',
    'var' (MODWT), 'pfwd', 'select', 'pinv' (MODWPT).

    The counterpart of the JAX package's ``pallas_supported`` family,
    re-derived from the 227 KB shared-memory budget of a block: any N runs,
    the halo must fit (Db4 runs to L=11 forward and variance, L=8 denoise,
    packet forward and select, L=7 packet inverse; Db4 L13's 57,337-sample
    halo does not fit).  The forwards' staging slices come out of their
    tiles, not their gates: 'fwd' runs where its halo fits beside a
    ``FWD_MIN_TILE`` tile, and 'pfwd' and 'pinv' where their 2L − 1 and 2L
    rows fit at the full 2048-sample tile.
    """
    if not (1 <= n < 2 ** 31 and level >= 1 and 1 <= m <= MAX_TAPS):
        return False
    if kind in ("pfwd", "pinv"):
        rows = 2 * level - (kind == "pfwd")
        if 4 * (2 * MAX_TAPS + rows * (TILES[kind] + halo(m, level))
                ) > SMEM_LIMIT:
            return False
    return (tile_of(kind, level, m) >= (FWD_MIN_TILE if kind == "fwd"
                                        else 1)
            and smem_bytes(level, m, kind) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=64)
def kernel_taps(wavelet: DiscreteWavelet):
    """(g̃, h̃) as contiguous float32 host arrays, as the kernels take them."""
    return tuple(np.ascontiguousarray(f, dtype=np.float32)
                 for f in modwt_base_filters(wavelet))


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def modwt_fwd_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: ``(..., N)`` →
    ``(level+1, ..., N)``, computed in float32 (float64 for float64 input)
    and returned in ``x``'s dtype."""
    cdt = _compute_dtype(x.dtype)
    g, h = (taps_as(f, cdt) for f in modwt_base_filters(wavelet))
    v = x.to(cdt)
    rows = []
    for j in range(1, level + 1):
        out = _conv_channels(v, (g, h), 1 << (j - 1), adjoint=False)
        rows.append(out[..., 1, :])
        v = out[..., 0, :]
    rows.append(v)
    return torch.stack(rows).to(x.dtype)


def modwt_inv_plain(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """The inverse kernel's function in plain PyTorch: ``(level+1, ..., N)``
    → ``(..., N)``, computed like :func:`modwt_fwd_plain`."""
    cdt = _compute_dtype(c.dtype)
    g, h = (taps_as(f, cdt) for f in modwt_base_filters(wavelet))
    level = c.shape[0] - 1
    v = c[level].to(cdt)
    for j in range(level, 0, -1):
        v = _combined_adjoint(v, c[j - 1].to(cdt), g, h, 1 << (j - 1))
    return v.to(c.dtype)


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library()
    for fn in (lib.jw_modwt_fwd, lib.jw_modwt_inv):
        fn.argtypes = [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def check_operand(t: torch.Tensor, name: str, ndim: int,
                  traced: bool = False) -> None:
    """Raise unless ``t`` is what the kernels take.  ``traced``: the check
    an operator's fake makes, on a traced or ``meta`` tensor, leaves out
    the device and the strides (which may be symbolic there); the launch
    checks both on the concrete tensor."""
    if not (traced or t.is_cuda):
        raise ValueError(f"{name}: kernel needs a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: kernel takes float32/bfloat16, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not (traced or t.is_contiguous()):
        raise ValueError(f"{name}: kernel needs a contiguous tensor")


def check_grid(batch: int, n: int, kind: str, tile: int | None = None
               ) -> None:
    if -(-n // (tile or TILES[kind])) * batch >= 2 ** 31:
        raise ValueError(f"{batch}×{n} exceeds the kernel grid")


class TilePlan(NamedTuple):
    """Launch geometry of a kernel that finishes its reduction over a row's
    tiles inside the launch ('var', 'select'): ``tile`` outputs a block,
    ``ntiles`` tiles a row, ``grid`` blocks (B × ntiles), ``smem`` bytes of
    shared memory a block, ``chain`` outputs in a thread's register chain."""
    tile: int
    ntiles: int
    grid: int
    smem: int
    chain: int


@functools.lru_cache(maxsize=256)
def tile_plan(kind: str, batch: int, n: int, level: int, m: int
              ) -> TilePlan:
    """Kernel ``kind``'s launch for (B, N) at this level and filter length
    (:func:`tile_of`); raises where :func:`kernel_supported` rejects the
    shape."""
    if not kernel_supported(n, level, m, kind):
        raise ValueError(f"unsupported shape ({batch}, {n}) level {level} "
                         f"for the '{kind}' kernel")
    tile = tile_of(kind, level, m)
    check_grid(batch, n, kind, tile)
    ntiles = -(-n // tile)
    return TilePlan(tile, ntiles, batch * ntiles, smem_bytes(level, m, kind),
                    CHAIN[kind])


_TICKETS: dict = {}


def tickets(device: torch.device, stream: int, rows: int) -> int:
    """Address of the per-row ticket counters of the kernels that finish
    their cross-tile reduction inside the launch ('var', 'select'): int32
    zeros, one buffer per (device, stream), at least ``rows`` long.  The
    row's last block resets its ticket, so the buffer is zero between
    launches; launches on one stream run in order, and two streams never
    share a buffer.  ``stream``: the CUDA stream handle the kernel runs on
    (the current stream's ``cuda_stream``)."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(max(rows, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf.data_ptr()


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


def check_taps(g, h) -> int:
    """Raise unless (g, h) is a filter pair the kernels take; its length."""
    if len(g) != len(h) or not 1 <= len(g) <= MAX_TAPS:
        raise ValueError(f"taps: need two filters of equal length in "
                         f"[1, {MAX_TAPS}], got {len(g)} and {len(h)}")
    return len(g)


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
    def define(launch):
        _OPS.define(name + torch.library.infer_schema(launch,
                                                      mutates_args=()))
        @spanned("jwave.launch." + name)
        @functools.wraps(launch)
        def counted(*args):
            out = launch(*args)
            LAUNCHES[name] += 1
            return out

        for key in ("CPU", "CUDA"):
            _OPS.impl(name, counted, key)
        op = getattr(torch.ops.jwave, name).default

        @functools.wraps(launch)
        def call(*args):
            return op(*args) if tracing() else counted(*args)

        call.register_fake = torch.library.register_fake(
            f"jwave::{name}", lib=_OPS)
        return call
    return define


def _check_fwd(x: torch.Tensor, g, h, level: int,
               traced: bool = True) -> None:
    check_operand(x, "x", 2, traced)
    if not kernel_supported(x.shape[1], level, check_taps(g, h), "fwd"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for the MODWT forward kernel")


@kernel_op("modwt_fwd")
def modwt_fwd_op(x: torch.Tensor, g: list[float], h: list[float],
                 level: int) -> torch.Tensor:
    """The forward kernel's launch as an operator (``torch.ops.jwave.
    modwt_fwd``): x (B, N) → (level+1, B, N), x's dtype.  The grid is
    planned here, from the concrete batch."""
    _check_fwd(x, g, h, level, traced=False)
    b, n = x.shape
    m = len(g)
    tile = tile_of("fwd", level, m)
    check_grid(b, n, "fwd", tile)
    out = torch.empty((level + 1, b, n), dtype=x.dtype, device=x.device)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwt_fwd(
        x.data_ptr(), out.data_ptr(), b, n, level, gh.ctypes.data,
        hh.ctypes.data, m, tile, halo(m, level),
        smem_bytes(level, m, "fwd"), DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "modwt forward kernel")
    return out


@modwt_fwd_op.register_fake
def _(x, g, h, level):
    _check_fwd(x, g, h, level)
    return x.new_empty((level + 1,) + tuple(x.shape))


def modwt_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                   level: int) -> torch.Tensor:
    """Launch the forward kernel as ``jwave::modwt_fwd``: x (B, N) →
    (level+1, B, N), x's dtype."""
    return modwt_fwd_op(x, *op_taps(wavelet), level)


def _check_inv(c: torch.Tensor, g, h, traced: bool = True) -> None:
    check_operand(c, "coeffs", 3, traced)
    if not kernel_supported(c.shape[2], c.shape[0] - 1, check_taps(g, h),
                            "inv"):
        raise ValueError(f"unsupported shape {tuple(c.shape)} for the MODWT "
                         f"inverse kernel")


@kernel_op("modwt_inv")
def modwt_inv_op(c: torch.Tensor, g: list[float], h: list[float]
                 ) -> torch.Tensor:
    """The inverse kernel's launch as an operator (``torch.ops.jwave.
    modwt_inv``): c (level+1, B, N) → (B, N), c's dtype."""
    _check_inv(c, g, h, traced=False)
    rows, b, n = c.shape
    level, m = rows - 1, len(g)
    check_grid(b, n, "inv")
    out = torch.empty((b, n), dtype=c.dtype, device=c.device)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwt_inv(
        c.data_ptr(), out.data_ptr(), b, n, level, gh.ctypes.data,
        hh.ctypes.data, m, TILES["inv"], halo(m, level),
        smem_bytes(level, m, "inv"), DTYPE_CODES[c.dtype], c.device.index,
        torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(lib, code, "modwt inverse kernel")
    return out


@modwt_inv_op.register_fake
def _(c, g, h):
    _check_inv(c, g, h)
    return c.new_empty(tuple(c.shape[1:]))


def modwt_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Launch the inverse kernel as ``jwave::modwt_inv``: c (level+1,
    B, N) → (B, N), c's dtype."""
    return modwt_inv_op(c, *op_taps(wavelet))


# ---------------------------------------------------------------------------
# Dispatch by device, and the autograd pair
# ---------------------------------------------------------------------------

def _modwt_fused_impl(x: torch.Tensor, wavelet: DiscreteWavelet,
                      level: int) -> torch.Tensor:
    if x.ndim not in (1, 2):
        raise ValueError(f"fused MODWT takes (N,) or (B, N), got "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    _check_level(n, level)
    if not kernel_supported(n, level, wavelet.length, "fwd"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} for fused MODWT")
    if x.is_cuda:
        out = modwt_fwd_cuda(x.contiguous().reshape(-1, n), wavelet, level)
        return out.reshape((level + 1,) + tuple(x.shape))
    if x.device.type != "cpu":
        raise ValueError(f"no MODWT kernel for device {x.device}")
    return modwt_fwd_plain(x, wavelet, level)


def _imodwt_fused_impl(c: torch.Tensor, wavelet: DiscreteWavelet
                       ) -> torch.Tensor:
    if c.ndim not in (2, 3):
        raise ValueError(f"fused iMODWT takes (L+1, N) or (L+1, B, N), got "
                         f"{tuple(c.shape)}")
    rows, n = c.shape[0], c.shape[-1]
    if not kernel_supported(n, rows - 1, wavelet.length, "inv"):
        raise ValueError(f"unsupported shape {tuple(c.shape)} for fused "
                         f"iMODWT")
    if c.is_cuda:
        out = modwt_inv_cuda(c.contiguous().reshape(rows, -1, n), wavelet)
        return out.reshape(tuple(c.shape[1:]))
    if c.device.type != "cpu":
        raise ValueError(f"no iMODWT kernel for device {c.device}")
    return modwt_inv_plain(c, wavelet)


class _ModwtFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wavelet, level):
        ctx.wavelet = wavelet
        return _modwt_fused_impl(x, wavelet, level)

    @staticmethod
    def backward(ctx, cot):
        return _imodwt_fused_impl(cot, ctx.wavelet), None, None


class _ImodwtFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, wavelet):
        ctx.wavelet, ctx.level = wavelet, c.shape[0] - 1
        return _imodwt_fused_impl(c, wavelet)

    @staticmethod
    def backward(ctx, cot):
        return _modwt_fused_impl(cot, ctx.wavelet, ctx.level), None


def modwt_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                level: int) -> torch.Tensor:
    """Fused forward MODWT: x (B, N) → (level+1, B, N), (N,) → (level+1, N);
    differentiable (the backward is the inverse kernel).

    A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
    version.  Raises for shapes :func:`kernel_supported` rejects.
    """
    return _ModwtFused.apply(x, wavelet, level)


def imodwt_fused(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Fused inverse MODWT: (level+1, B, N) → (B, N), (level+1, N) → (N,);
    differentiable (the backward is the forward kernel)."""
    return _ImodwtFused.apply(c, wavelet)
