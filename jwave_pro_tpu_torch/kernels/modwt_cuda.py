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
shared-memory budget (:func:`kernel_supported`).

Beside each kernel: its plain PyTorch version (``modwt_fwd_plain``,
``modwt_inv_plain``), which the CPU path runs and the chip smoke compares
against, and a launch counter (``modwt_fwd_cuda.launches``,
``modwt_inv_cuda.launches``).  bfloat16 tensors are read and written as
bfloat16 and computed in float32, in the kernels and their plain versions
alike.  The autograd pair (:func:`modwt_fused`, :func:`imodwt_fused`) rests
on Aᵀ = A⁻¹ for the analysis operator A: each direction's backward is the
other kernel.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.modwt import (
    _check_level, _combined_adjoint, _conv_channels, modwt_base_filters,
    taps_as,
)
from ..wavelets.base import DiscreteWavelet
from . import _build

__all__ = [
    "modwt_fused", "imodwt_fused", "kernel_supported",
    "modwt_fwd_cuda", "modwt_inv_cuda", "modwt_fwd_plain", "modwt_inv_plain",
]

MAX_TAPS = 64                 # JW_MAX_TAPS in csrc/common.cuh
SMEM_LIMIT = 232_448          # shared memory one H100 block may use (227 KB)
TILES = {"fwd": 4096, "inv": 4096, "denoise": 2048}   # outputs per block
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # JwDtype

_P, _I = ctypes.c_void_p, ctypes.c_int


def halo(m: int, level: int) -> int:
    """Exact context one output needs: (M−1)(2^L − 1) samples."""
    return (m - 1) * ((1 << level) - 1)


def smem_bytes(level: int, m: int, kind: str) -> int:
    """Dynamic shared memory of one block: the taps plus the window rows
    (two V buffers for 'fwd'; two V and one W for 'inv'; two V and L
    W rows over a two-sided window for 'denoise')."""
    h, t = halo(m, level), TILES[kind]
    rows = {"fwd": 2 * (t + h), "inv": 3 * (t + h),
            "denoise": (level + 2) * (t + 2 * h)}[kind]
    return 4 * (2 * MAX_TAPS + rows)


def kernel_supported(n: int, level: int, m: int, kind: str) -> bool:
    """Whether kernel ``kind`` ('fwd', 'inv', 'denoise') runs this shape.

    The counterpart of ``pallas_supported``/``denoise_fused_supported``,
    re-derived from the 227 KB shared-memory budget of a block: any N runs,
    the halo must fit (Db4 runs to L=11 forward, L=8 denoise; Db4 L13's
    57,337-sample halo does not fit).
    """
    return (1 <= n < 2 ** 31 and level >= 1 and 1 <= m <= MAX_TAPS
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


def check_operand(t: torch.Tensor, name: str, ndim: int) -> None:
    """Raise unless ``t`` is what the kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: kernel needs a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: kernel takes float32/bfloat16, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel needs a contiguous tensor")


def check_grid(batch: int, n: int, kind: str) -> None:
    if -(-n // TILES[kind]) * batch >= 2 ** 31:
        raise ValueError(f"{batch}×{n} exceeds the kernel grid")


def modwt_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                   level: int) -> torch.Tensor:
    """Launch the forward kernel: x (B, N) → (level+1, B, N), x's dtype."""
    check_operand(x, "x", 2)
    b, n = x.shape
    m = wavelet.length
    if not kernel_supported(n, level, m, "fwd"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for the MODWT forward kernel")
    check_grid(b, n, "fwd")
    out = torch.empty((level + 1, b, n), dtype=x.dtype, device=x.device)
    g, h = kernel_taps(wavelet)
    lib = _lib()
    code = lib.jw_modwt_fwd(
        x.data_ptr(), out.data_ptr(), b, n, level, g.ctypes.data,
        h.ctypes.data, m, TILES["fwd"], halo(m, level),
        smem_bytes(level, m, "fwd"), DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "modwt forward kernel")
    modwt_fwd_cuda.launches += 1
    return out


modwt_fwd_cuda.launches = 0


def modwt_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Launch the inverse kernel: c (level+1, B, N) → (B, N), c's dtype."""
    check_operand(c, "coeffs", 3)
    rows, b, n = c.shape
    level, m = rows - 1, wavelet.length
    if not kernel_supported(n, level, m, "inv"):
        raise ValueError(f"unsupported shape {tuple(c.shape)} for the MODWT "
                         f"inverse kernel")
    check_grid(b, n, "inv")
    out = torch.empty((b, n), dtype=c.dtype, device=c.device)
    g, h = kernel_taps(wavelet)
    lib = _lib()
    code = lib.jw_modwt_inv(
        c.data_ptr(), out.data_ptr(), b, n, level, g.ctypes.data,
        h.ctypes.data, m, TILES["inv"], halo(m, level),
        smem_bytes(level, m, "inv"), DTYPE_CODES[c.dtype], c.device.index,
        torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(lib, code, "modwt inverse kernel")
    modwt_inv_cuda.launches += 1
    return out


modwt_inv_cuda.launches = 0


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
