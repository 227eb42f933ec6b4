"""Fused MODWT denoise kernel for the H100 (``csrc/denoise.cu``).

Replaces ``jwave_pro_tpu/kernels/denoise_pallas.py`` ``_denoise_kernel``
(``:68``): forward → soft/hard shrink of W_1..W_L by a per-signal threshold,
V_L kept → inverse, in one pass with a two-sided halo and no coefficient
output.

It moves 1 read + 1 write per sample against 2(L+2) passes for the
two-kernel round trip, so what bounds it on the H100 is the cascade: 2M
FMAs an output and level, in the analysis and the synthesis alike.  The
kernel is templated on the filter length (taps as parameter-bank
operands) and computes both in register chains of ``CHAIN['denoise']``
outputs a thread; the analysis values are bitwise those of one fmaf chain
over the taps, so no hard-threshold decision depends on the chains.  The
price of the fusion is (L+2) window rows of shared memory per block
(about 70 KB at Db4 L5), which :func:`kernel_supported` ('denoise')
budgets.  Any N runs, since each block reads its circular context
directly.

Beside the kernel: its plain PyTorch version (:func:`modwt_denoise_plain`)
and its launch count (``modwt_cuda.LAUNCHES["modwt_denoise"]``).  The
launch is the operator ``jwave::modwt_denoise`` (``kernels/modwt_cuda.py``
says why).  Not differentiable: shrinkage is piecewise; the
``method='auto'`` pipeline is.
"""
from __future__ import annotations

import functools

import torch

from ..ops.denoise import hard_threshold, soft_threshold
from ..ops.modwt import _check_level
from ..wavelets.base import DiscreteWavelet
from . import _build
from .modwt_cuda import (
    _I, _P, DTYPE_CODES, TILES, _compute_dtype, check_grid, check_operand,
    check_taps, halo, host_taps, kernel_supported, modwt_fwd_plain,
    modwt_inv_plain, op_taps, smem_bytes, kernel_op,
)

__all__ = ["modwt_denoise_fused", "modwt_denoise_cuda", "modwt_denoise_plain",
           "modwt_denoise_op"]


def modwt_denoise_plain(x: torch.Tensor, threshold: torch.Tensor,
                        wavelet: DiscreteWavelet, level: int,
                        mode: str = "soft") -> torch.Tensor:
    """The denoise kernel's function in plain PyTorch: x (B, N), threshold
    (B,) → (B, N).  The whole chain runs in float32 (float64 for float64
    input) and rounds to ``x``'s dtype once, at the end, as the kernel does.
    """
    cdt = _compute_dtype(x.dtype)
    c = modwt_fwd_plain(x.to(cdt), wavelet, level)
    shrink = soft_threshold if mode == "soft" else hard_threshold
    thr = threshold.to(dtype=cdt, device=x.device)[None, :, None]
    c = torch.cat([shrink(c[:level], thr), c[level:]], dim=0)
    return modwt_inv_plain(c, wavelet).to(x.dtype)


@functools.cache
def _lib():
    lib = _build.library()
    lib.jw_modwt_denoise.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _P]
    lib.jw_modwt_denoise.restype = _I
    return lib


def _check_denoise(x: torch.Tensor, threshold: torch.Tensor, g, h,
                   level: int, traced: bool = True) -> None:
    check_operand(x, "x", 2, traced)
    if (threshold.dtype != torch.float32 or threshold.ndim != 1
            or not traced and (threshold.shape[0] != x.shape[0]
                               or threshold.device != x.device
                               or not threshold.is_contiguous())):
        raise ValueError("threshold: kernel needs a contiguous (B,) float32 "
                         "tensor on x's device")
    if not kernel_supported(x.shape[1], level, check_taps(g, h), "denoise"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for the fused denoise kernel")


@kernel_op("modwt_denoise")
def modwt_denoise_op(x: torch.Tensor, threshold: torch.Tensor,
                     g: list[float], h: list[float], level: int,
                     hard: int) -> torch.Tensor:
    """The denoise kernel's launch as an operator (``torch.ops.jwave.
    modwt_denoise``): x (B, N), threshold (B,) float32 → (B, N); ``hard``
    1 for hard shrinkage, 0 for soft."""
    _check_denoise(x, threshold, g, h, level, traced=False)
    b, n = x.shape
    m = len(g)
    check_grid(b, n, "denoise")
    out = torch.empty_like(x)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwt_denoise(
        x.data_ptr(), threshold.data_ptr(), out.data_ptr(), b, n, level,
        gh.ctypes.data, hh.ctypes.data, m, TILES["denoise"], halo(m, level),
        smem_bytes(level, m, "denoise"), int(hard), DTYPE_CODES[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "fused denoise kernel")
    return out


@modwt_denoise_op.register_fake
def _(x, threshold, g, h, level, hard):
    _check_denoise(x, threshold, g, h, level)
    return torch.empty_like(x)


def modwt_denoise_cuda(x: torch.Tensor, threshold: torch.Tensor,
                       wavelet: DiscreteWavelet, level: int,
                       mode: str = "soft") -> torch.Tensor:
    """Launch the denoise kernel as ``jwave::modwt_denoise``: x (B, N),
    threshold (B,) float32 → (B, N)."""
    return modwt_denoise_op(x, threshold, *op_taps(wavelet), level,
                            int(mode != "soft"))


def modwt_denoise_fused(x: torch.Tensor, threshold: torch.Tensor,
                        wavelet: DiscreteWavelet, level: int,
                        mode: str = "soft") -> torch.Tensor:
    """Single-pass MODWT denoise: x (B, N), threshold (B,) → (B, N).

    ``threshold`` is per signal (broadcast over scales, as in
    ``MODWTExample.java:151-166``).  A CUDA tensor runs the kernel or
    raises; a CPU tensor runs the plain version.  Raises for shapes
    :func:`kernel_supported` rejects.  Use :func:`ops.denoise.modwt_denoise`
    (``method='fused'``) for the public path with automatic thresholds.
    """
    if x.ndim != 2:
        raise ValueError(f"fused denoise takes (B, N), got {tuple(x.shape)}")
    n = x.shape[-1]
    _check_level(n, level)
    if not kernel_supported(n, level, wavelet.length, "denoise"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} for fused "
                         f"denoise")
    if x.is_cuda:
        return modwt_denoise_cuda(x.contiguous(), threshold, wavelet, level,
                                  mode)
    if x.device.type != "cpu":
        raise ValueError(f"no denoise kernel for device {x.device}")
    return modwt_denoise_plain(x, threshold, wavelet, level, mode)
