"""Threshold compression of coefficient arrays.

Counterpart of ``jwave_pro_tpu/ops/compress.py``; same semantics and
names.  Parity with ``jwave/compressions/``: keep coefficients with
``|c| ≥ magnitude·threshold``, zero the rest (``Compressor.java:95-180``).
One ``torch.where`` each — shape-agnostic (1D/2D/3D and batched at once,
where the reference has three hand-written overloads per compressor).
"""
from __future__ import annotations

import torch

from ..utils.device import as_input

__all__ = [
    "compress_magnitude", "compress_peaks_average", "compress_fixed",
    "compression_rate",
]


def compress_fixed(c: torch.Tensor, magnitude, threshold: float = 1.0
                   ) -> torch.Tensor:
    """Zero all |c| < magnitude·threshold (``Compressor.compress``)."""
    c = as_input(c)
    return torch.where(torch.abs(c) >= magnitude * threshold, c,
                       0.0).to(c.dtype)


def compress_magnitude(c: torch.Tensor, threshold: float = 1.0
                       ) -> torch.Tensor:
    """Magnitude = mean(|c|) over the whole array
    (``CompressorMagnitude.java:73-134``)."""
    c = as_input(c)
    return compress_fixed(c, torch.mean(torch.abs(c)), threshold)


def compress_peaks_average(c: torch.Tensor, threshold: float = 1.0
                           ) -> torch.Tensor:
    """Magnitude = ½·(peakMax − peakMin) over |c|.

    The reference initializes its running minimum to 0 and only lowers it
    (``CompressorPeaksAverage.java:70-96``), so peakMin is always 0 and the
    magnitude is ``max(|c|)/2`` — reproduced faithfully.
    """
    c = as_input(c)
    return compress_fixed(c, 0.5 * torch.max(torch.abs(c)), threshold)


def compression_rate(c: torch.Tensor) -> torch.Tensor:
    """Percentage of zeros (``Compressor.calcCompressionRate``,
    ``:182-204``): float64 for float64 input, else float32."""
    c = as_input(c)
    dtype = torch.float64 if c.dtype == torch.float64 else torch.float32
    return 100.0 * torch.mean((c == 0.0).to(dtype))
