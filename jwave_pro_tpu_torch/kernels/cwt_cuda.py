"""Fused CWT multiply + inverse FFT kernel for the H100 (``csrc/cwt.cu``).

Replaces ``jwave_pro_tpu/kernels/cwt_pallas.py`` ``_kernel`` (``:105``):
for each signal b and scale s, W = X[b]·M[s] on the full P-point frequency
grid, then the inverse DFT with 1/P, cropped to n — the coefficients
``(B, S, n)``, complex64, or float32 (the real part) when M is Hermitian in
k (a real-even ψ̂).  The TPU kernel computed the inverse DFT as two stages of
MXU matrix products in a 3-pass bf16 split, for want of an f32 matrix path;
here it is an f32 Stockham inverse FFT held in registers: P/E threads a row
(E = 8..32 complex values each), two or three passes, one per factor of P
(16384 = 32·32·16), each an R-point DFT fully unrolled in registers, with at
most two exchanges of the row through padded (conflict-free) shared memory.
The product is fused into the first pass and the crop and the real/complex
output into the last, written with streaming stores.  Blocks are
persistent and loop over rows; the twiddles e^{2πit/P} are a table this
module builds once per P and device (:func:`twiddles`).  The signal's
forward FFT stays ``torch.fft.fft`` outside the kernel, as the JAX package
leaves it to XLA.

What bounds it on the H100: device memory for the output (537 MB of
complex64 at 64 × 64 × 16384); the FFT's 5·P·log₂P flops a row are a small
share of the f32 rate.  :func:`cwt_fused_supported` takes what the JAX
package's gate takes: a power-of-two P in [64, 16384] (a padded 16384-point
row fills 135 KB of the 227 KB), any B and S.

Beside the kernel: its plain PyTorch version :func:`cwt_ifft_plain` (the
JAX kernel's two-stage DFT with the same stage constants, as complex
matrix products in float32, or float64 for complex128 input) and a launch
count (``_launch.LAUNCHES["cwt_ifft"]``).  The launch is the operator
``jwave::cwt_ifft``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ._launch import check_operand, kernel_op, launch

__all__ = [
    "cwt_fused_supported", "cwt_ifft_fused", "cwt_ifft_cuda",
    "cwt_ifft_plain", "cwt_ifft_op", "twiddles",
]

P_MIN, P_MAX = 64, 16384


def _factor_p(p: int):
    """Split a power-of-two P into the two DFT stages (P1, P2), as the JAX
    kernel does: P2 = 128 from P = 1024 on, else a square-ish split."""
    if p & (p - 1) or p < P_MIN or p > P_MAX:
        return None
    if p >= 1024:
        return p // 128, 128
    lg = p.bit_length() - 1
    p1 = 1 << ((lg + 1) // 2)
    return p1, p // p1


def cwt_fused_supported(batch: int, n_scales: int, p: int) -> bool:
    """Whether the fused kernel runs B signals × S scales at padded length
    P: a power of two in [64, 16384] (``cwt_pallas.cwt_fused_supported``'s
    range), any B ≥ 1 and S ≥ 1."""
    return batch >= 1 and n_scales >= 1 and _factor_p(p) is not None


@functools.lru_cache(maxsize=16)
def _dft_constants(p1: int, p2: int):
    """(E1, T, E2) complex128 stage constants of ``cwt_pallas.
    _dft_constants``: E1[ω1, t1] = e^{2πi·ω1·t1/P1}, T[ω2, t1] =
    e^{2πi·ω2·t1/P}, E2[ω2, t2] = e^{2πi·ω2·t2/P2}/P."""
    p = p1 * p2
    w1, t1 = np.meshgrid(np.arange(p1), np.arange(p1), indexing="ij")
    e1 = np.exp(2j * np.pi * w1 * t1 / p1)
    w2, t1b = np.meshgrid(np.arange(p2), np.arange(p1), indexing="ij")
    tw = np.exp(2j * np.pi * w2 * t1b / p)
    w2b, t2 = np.meshgrid(np.arange(p2), np.arange(p2), indexing="ij")
    e2 = np.exp(2j * np.pi * w2b * t2 / p2) / p
    return e1, tw, e2


def cwt_ifft_plain(xf: torch.Tensor, mult: torch.Tensor, n: int,
                   is_real: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch: xf (B, P), mult (S, P)
    complex → (B, S, n).

    The JAX kernel's two-stage DFT (P = P1·P2, k = ω1·P2 + ω2,
    t = t1 + P1·t2): contract ω1 against E1, twiddle by T, contract ω2
    against E2 (which carries 1/P), then crop to n; the real part when
    ``is_real``.  Computed in complex64 (complex128 for complex128 input).
    """
    b, p = xf.shape
    s = mult.shape[0]
    p1, p2 = _factor_p(p)
    cdt = torch.complex128 if xf.dtype == torch.complex128 else \
        torch.complex64
    e1, tw, e2 = (torch.from_numpy(c).to(device=xf.device, dtype=cdt)
                  for c in _dft_constants(p1, p2))
    w = (xf.to(cdt)[:, None, :] * mult.to(cdt)).reshape(b, s, p1, p2)
    z = torch.matmul(w.transpose(-1, -2), e1) * tw     # (B, S, ω2, t1)
    c = torch.matmul(z.transpose(-1, -2), e2)          # (B, S, t1, t2)
    c = c.transpose(-1, -2).reshape(b, s, p)[..., :n]  # t = t1 + P1·t2
    return c.real.contiguous() if is_real else c.contiguous()


@functools.lru_cache(maxsize=None)
def twiddles(p: int, device: torch.device) -> torch.Tensor:
    """(P,) complex64 e^{2πit/P}, t < P, computed in float64 and rounded
    once: the kernel's twiddle table, one per P and device."""
    t = np.exp(2j * np.pi * np.arange(p) / p).astype(np.complex64)
    return torch.from_numpy(t).to(device)


def _check_cwt(xf: torch.Tensor, mult: torch.Tensor, n: int,
               traced: bool) -> None:
    """The launch's checks; ``traced``: the fake's, on a traced or ``meta``
    tensor (no device, strides or batch)."""
    for t, name in ((xf, "xf"), (mult, "mult")):
        check_operand(t, name, 2, traced, (torch.complex64,))
    p = xf.shape[1]
    if mult.shape[1] != p or not (traced or mult.device == xf.device):
        raise ValueError("mult: need (S, P) on xf's device")
    b = 1 if traced else xf.shape[0]
    if not cwt_fused_supported(b, mult.shape[0], p) or not 1 <= n <= p:
        raise ValueError(f"unsupported length P={p}, n={n} for the CWT "
                         f"kernel (P a power of two in [{P_MIN}, {P_MAX}])")


@kernel_op("cwt_ifft")
def cwt_ifft_op(xf: torch.Tensor, mult: torch.Tensor, n: int,
                is_real: int) -> torch.Tensor:
    """The kernel's launch as an operator (``torch.ops.jwave.cwt_ifft``):
    xf (B, P), mult (S, P) complex64 on one CUDA device → (B, S, n)
    complex64, or float32 when ``is_real`` is 1."""
    _check_cwt(xf, mult, n, False)
    b, p = xf.shape
    s = mult.shape[0]
    if b * s >= 2 ** 31:
        raise ValueError(f"{b}×{s} rows exceed the CWT kernel grid")
    out = torch.empty((b, s, n), device=xf.device,
                      dtype=torch.float32 if is_real else torch.complex64)
    launch("jw_cwt_ifft", "CWT kernel", xf.device, xf.data_ptr(),
           mult.data_ptr(), twiddles(p, xf.device).data_ptr(), out.data_ptr(),
           b, s, p, n, int(is_real))
    return out


@cwt_ifft_op.register_fake
def _(xf, mult, n, is_real):
    _check_cwt(xf, mult, n, True)
    return xf.new_empty((xf.shape[0], mult.shape[0], n),
                        dtype=torch.float32 if is_real else torch.complex64)


def cwt_ifft_cuda(xf: torch.Tensor, mult: torch.Tensor, n: int,
                  is_real: bool) -> torch.Tensor:
    """Launch the kernel as ``jwave::cwt_ifft``: xf (B, P), mult (S, P)
    complex64 on one CUDA device → (B, S, n) complex64, or float32 when
    ``is_real``."""
    return cwt_ifft_op(xf, mult, n, int(is_real))


def cwt_ifft_fused(xf: torch.Tensor, mult: torch.Tensor, n: int,
                   is_real: bool) -> torch.Tensor:
    """Fused multiply + inverse FFT: a CUDA tensor runs the kernel or
    raises; a CPU tensor runs the plain version."""
    if xf.is_cuda:
        return cwt_ifft_cuda(xf.contiguous(), mult.contiguous(), n, is_real)
    if xf.device.type != "cpu":
        raise ValueError(f"no CWT kernel for device {xf.device}")
    return cwt_ifft_plain(xf, mult, n, is_real)
