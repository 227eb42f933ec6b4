"""Fourier transforms — thin wrappers over ``torch.fft`` with reference
parity.

Counterpart of ``jwave_pro_tpu/ops/fft.py``; same semantics and names.  The
reference hand-rolls iterative Cooley-Tukey for 2^p and Bluestein chirp-z
for arbitrary N (``jwave/transforms/FastFourierTransform.java:172-324``)
with NumPy normalization (forward unscaled, inverse 1/N, ``:205-211``).
``torch.fft`` (cuFFT on the card) handles arbitrary N with the same
normalization, so both reference engines collapse into one call; the
O(N²) educational DFTs (``DiscreteFourierTransform.java``) are an explicit
matrix product, pinned to IEEE float32 on the card (cuBLAS's complex
float32 product follows the TF32 setting otherwise) as the JAX package
computes it at ``Precision.HIGHEST``.

The interleaved real-array API (re,im,re,im,...) of the reference's 1D
``forward(double[])`` is kept for drop-in familiarity.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import as_input
from .fwt import _const, _mm

__all__ = [
    "fft", "ifft", "fft_interleaved", "ifft_interleaved",
    "dft_matrix", "dft", "idft",
]


def _as_complex(x) -> torch.Tensor:
    """complex128 for float64 input, complex64 for any other real input;
    complex input as it is."""
    x = as_input(x)
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


def fft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Forward FFT, unscaled (FastFourierTransform.java:112-134)."""
    return torch.fft.fft(_as_complex(x), dim=axis)


def ifft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse FFT with 1/N (FastFourierTransform.java:142-164)."""
    return torch.fft.ifft(_as_complex(x), dim=axis)


def _deinterleave(arr: torch.Tensor) -> torch.Tensor:
    re = arr[..., 0::2]
    im = arr[..., 1::2]
    return re + 1j * im


def _interleave(z: torch.Tensor) -> torch.Tensor:
    out = torch.stack([z.real, z.imag], dim=-1)
    return out.reshape(out.shape[:-2] + (out.shape[-2] * 2,))


def fft_interleaved(arr: torch.Tensor) -> torch.Tensor:
    """FFT of an interleaved (re,im,...) real array → interleaved result.

    Parity with ``BasicTransform.forward(double[])`` FFT path
    (``BasicTransform.java:257-322`` complex adapters).
    """
    return _interleave(fft(_deinterleave(as_input(arr))))


def ifft_interleaved(arr: torch.Tensor) -> torch.Tensor:
    return _interleave(ifft(_deinterleave(as_input(arr))))


def dft_matrix(n: int, inverse: bool = False, dtype=np.complex128):
    """The DFT matrix W[k,t] = e^{∓2πi·kt/n} (÷n when inverse), host numpy.

    The O(N²) baseline of ``DiscreteFourierTransform.java:73-117`` as one
    matmul.
    """
    k = np.arange(n)
    sign = 2.0j if inverse else -2.0j
    w = np.exp(sign * np.pi * np.outer(k, k) / n)
    if inverse:
        w = w / n
    return w.astype(dtype)


def dft(x: torch.Tensor) -> torch.Tensor:
    """Naive DFT via matrix product (educational / cross-validation)."""
    x = _as_complex(x)
    w = _const(dft_matrix, x.shape[-1], like=x)
    return _mm(x, w.mT)


def idft(x: torch.Tensor) -> torch.Tensor:
    x = _as_complex(x)
    w = _const(dft_matrix, x.shape[-1], True, like=x)
    return _mm(x, w.mT)
