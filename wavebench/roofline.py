"""The least time an NVIDIA H100 could take for a call: the yardstick of the
``*_roofline`` metrics.

A call's bound is the larger of its bytes over the card's memory rate and
its float32 operations over the card's float32 rate (NVIDIA's data sheet,
H100 SXM, dense, at the full 700 W limit).  The bytes count every input
read once and every output written once; the operations are those the
transform needs, counted from the shapes, not those one implementation
happens to do.  ``modwt_fwd`` and ``cwt_ifft`` are frozen copies of the
arithmetic the port's kernel table was measured against; ``cwt`` is the
whole continuous transform.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(seconds, 'bytes' or 'operations'): the least time to move
    ``nbytes`` and do ``flops`` float32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def modwt_fwd(rows: int, n: int, level: int, taps: int):
    """Forward MODWT of (rows, n) float32 to (level + 1, rows, n): the
    signal read, every row written; one multiply-add (2 operations) per
    tap, output sample and branch, two branches a level."""
    cells = rows * n
    return bound(4 * cells * (level + 2), cells * 4 * taps * level)


def cwt_ifft(batch: int, padded: int, scales: int):
    """The CWT's fused multiply and inverse FFT (kernel #14): a complex64
    spectrum per signal and a complex64 multiplier per scale read, a
    complex64 row per signal and scale written; 6 operations a complex
    product and 5·P·log₂P an inverse FFT."""
    rows = batch * scales
    return bound(8 * (batch * padded + scales * padded + rows * padded),
                 rows * (6 * padded + 5 * padded * int(math.log2(padded))))


def cwt(batch: int, n: int, scales: int):
    """The whole CWT of (batch, n) float32 to (batch, scales, n) complex64:
    the signal read, the coefficients written; one FFT per signal, one
    complex product and one inverse FFT per signal and scale, all at the
    signal's own length (5·n·log₂n an FFT, 6 a product)."""
    fft = 5 * n * math.log2(n)
    return bound(4 * batch * n + 8 * batch * scales * n,
                 batch * fft + batch * scales * (fft + 6 * n))
