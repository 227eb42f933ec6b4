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
and its launch count (``_launch.LAUNCHES["modwt_denoise"]``).  The
launch is the operator ``jwave::modwt_denoise`` (``kernels/_launch.py``
says why).  Not differentiable: shrinkage is piecewise; the
``method='auto'`` pipeline is.
"""
from __future__ import annotations

import torch

from ..ops.denoise import hard_threshold, soft_threshold
from ..ops.modwt import _check_level
from ..wavelets.base import DiscreteWavelet
from ._launch import (
    DTYPE_CODES, check_grid, check_operand, check_taps, check_threshold,
    compute_dtype, host_taps, kernel_op, launch, op_taps,
)
from .modwt_cuda import (
    KernelPlan, check_fused, modwt_fwd_plain, modwt_inv_plain, require_plan,
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
    cdt = compute_dtype(x.dtype)
    c = modwt_fwd_plain(x.to(cdt), wavelet, level)
    shrink = soft_threshold if mode == "soft" else hard_threshold
    thr = threshold.to(dtype=cdt, device=x.device)[None, :, None]
    c = torch.cat([shrink(c[:level], thr), c[level:]], dim=0)
    return modwt_inv_plain(c, wavelet).to(x.dtype)


def _check_denoise(x: torch.Tensor, threshold: torch.Tensor, g, h,
                   level: int, traced: bool = True) -> KernelPlan:
    check_operand(x, "x", 2, traced)
    check_threshold(threshold, x, traced)
    return require_plan("denoise", x.shape[1], level, check_taps(g, h),
                        x.shape, "fused denoise")


@kernel_op("modwt_denoise")
def modwt_denoise_op(x: torch.Tensor, threshold: torch.Tensor,
                     g: list[float], h: list[float], level: int,
                     hard: int) -> torch.Tensor:
    """The denoise kernel's launch as an operator (``torch.ops.jwave.
    modwt_denoise``): x (B, N), threshold (B,) float32 → (B, N); ``hard``
    1 for hard shrinkage, 0 for soft."""
    plan = _check_denoise(x, threshold, g, h, level, traced=False)
    b, n = x.shape
    check_grid(b, n, plan.tile)
    out = torch.empty_like(x)
    gh, hh = host_taps(g, h)
    launch("jw_modwt_denoise", "fused denoise kernel", x.device, x.data_ptr(),
           threshold.data_ptr(), out.data_ptr(), b, n, level, gh.ctypes.data,
           hh.ctypes.data, len(g), *plan, int(hard), DTYPE_CODES[x.dtype])
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
    _check_level(x.shape[-1], level)
    check_fused(x, "denoise", level, wavelet.length, "fused denoise")
    if x.is_cuda:
        return modwt_denoise_cuda(x.contiguous(), threshold, wavelet, level,
                                  mode)
    return modwt_denoise_plain(x, threshold, wavelet, level, mode)
