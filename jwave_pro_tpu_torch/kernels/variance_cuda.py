"""Fused MODWT wavelet-variance kernel for the H100 (``csrc/variance.cu``).

Replaces ``jwave_pro_tpu/kernels/variance_pallas.py`` ``_var_kernel``
(``:80``): the forward cascade with each level's Σw² in place of the
stores, so the coefficients never reach device memory.  The sum over a
row's tiles is finished inside the one launch, as the TPU kernel
accumulated across its sequential grid axis: the row's last block to
finish (an atomic ticket) adds the tiles' sums in tile order and writes
the ``(level+1, B)`` means, so the result does not depend on the order the
blocks ran in.  The tickets live in one small buffer per (device, stream)
(:func:`kernels.modwt_cuda.tickets`), zero between launches.

What bounds it on the H100: one read per sample and no stores, so the
cascade (2M FMAs per sample and level) and the shared-memory accesses that
feed it: the kernel takes the taps from the parameter bank and computes
register chains of ``modwt_cuda.CHAIN['var']`` outputs a thread
(:func:`var_plan`).  Any N runs: positions past N never count.

Beside the kernel: its plain PyTorch version (:func:`modwt_var_plain`) and
its launch count (``modwt_cuda.LAUNCHES["modwt_var"]``).  The launch is
the operator ``jwave::modwt_var``; the tile plan and the ticket buffer are
taken inside it, from the concrete batch.  The result is float32
for float32 and bfloat16 input alike.
"""
from __future__ import annotations

import functools

import torch

from ..ops.modwt import _check_level
from ..wavelets.base import DiscreteWavelet
from . import _build
from .modwt_cuda import (
    _I, _P, DTYPE_CODES, TilePlan, _compute_dtype, check_operand, check_taps,
    host_taps, kernel_supported, modwt_fwd_plain, op_taps, tickets, tile_plan,
    kernel_op,
)

__all__ = ["modwt_var_fused", "modwt_var_cuda", "modwt_var_plain",
           "modwt_var_op", "var_plan"]


def modwt_var_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """The variance kernel's function in plain PyTorch: ``(..., N)`` →
    ``(level+1, ...)`` rows ``mean(W_1²) … mean(W_L²), mean(V_L²)``,
    computed (and returned) in float32, float64 for float64 input."""
    c = modwt_fwd_plain(x.to(_compute_dtype(x.dtype)), wavelet, level)
    return torch.mean(c * c, dim=-1)


def var_plan(batch: int, n: int, level: int, m: int) -> TilePlan:
    """The variance kernel's launch (:func:`kernels.modwt_cuda.tile_plan`)."""
    return tile_plan("var", batch, n, level, m)


@functools.cache
def _lib():
    lib = _build.library()
    lib.jw_modwt_var.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I,
                                 _I, _I, _I, _P]
    lib.jw_modwt_var.restype = _I
    return lib


def _check_var(x: torch.Tensor, g, h, level: int,
               traced: bool = True) -> None:
    check_operand(x, "x", 2, traced)
    if not kernel_supported(x.shape[1], level, check_taps(g, h), "var"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for the 'var' kernel")


@kernel_op("modwt_var")
def modwt_var_op(x: torch.Tensor, g: list[float], h: list[float],
                 level: int) -> torch.Tensor:
    """The variance kernel's launch as an operator (``torch.ops.jwave.
    modwt_var``): x (B, N) → (level+1, B) float32.  The tile plan, the
    partial sums and the ticket buffer are taken here, from the concrete
    batch; one launch and nothing else on the stream."""
    _check_var(x, g, h, level, traced=False)
    b, n = x.shape
    m = len(g)
    plan = var_plan(b, n, level, m)
    partial = torch.empty((level + 1, b, plan.ntiles), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((level + 1, b), dtype=torch.float32, device=x.device)
    gh, hh = host_taps(g, h)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    code = lib.jw_modwt_var(
        x.data_ptr(), partial.data_ptr(), tickets(x.device, stream, b),
        out.data_ptr(), b, n, level, gh.ctypes.data, hh.ctypes.data, m,
        plan.tile, plan.smem, DTYPE_CODES[x.dtype], x.device.index, stream)
    _build.check(lib, code, "fused variance kernel")
    return out


@modwt_var_op.register_fake
def _(x, g, h, level):
    _check_var(x, g, h, level)
    return x.new_empty((level + 1, x.shape[0]), dtype=torch.float32)


def modwt_var_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                   level: int) -> torch.Tensor:
    """Launch the variance kernel as ``jwave::modwt_var``: x (B, N) →
    (level+1, B) float32."""
    return modwt_var_op(x, *op_taps(wavelet), level)


def modwt_var_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """Fused per-scale second moments: x (B, N) → (level+1, B), (N,) →
    (level+1,), rows ``mean(W_1²) … mean(W_L²), mean(V_L²)``.

    Rows 0..level−1 are the biased, all-N, circular wavelet variances ν²_j
    of :func:`ops.analysis.modwt_variance`.  A CUDA tensor runs the kernel
    or raises; a CPU tensor runs the plain version.  Raises for shapes
    :func:`kernel_supported` rejects.
    """
    if x.ndim not in (1, 2):
        raise ValueError(f"fused variance takes (N,) or (B, N), got "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    _check_level(n, level)
    if not kernel_supported(n, level, wavelet.length, "var"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} for fused "
                         f"variance")
    if x.is_cuda:
        out = modwt_var_cuda(x.contiguous().reshape(-1, n), wavelet, level)
        return out.reshape((level + 1,) + tuple(x.shape[:-1]))
    if x.device.type != "cpu":
        raise ValueError(f"no variance kernel for device {x.device}")
    return modwt_var_plain(x, wavelet, level)
