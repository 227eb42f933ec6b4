"""The continuous wavelet transform with a Morlet wavelet, plain.

For a signal x of length n, zero-padded to P (the next power of two):

    c[s, t] = IFFT_P( X[k] · conj(√a_s · ψ̂(a_s·ω_k)) )[t],   t < n

with X = FFT_P(x), ω_k = 2π·k·fs/P for k ≤ P/2 and ω_k − 2π·fs past it,
and the Morlet spectrum of bandwidth f_b and centre frequency f_c

    ψ̂(ω) = √(2π·f_b) · exp(−2π²·f_b·(ω/2π − f_c)²),

where Morlet(ω₀) is f_b = 2, f_c = ω₀/2π (Torrence and Compo, 1998).
The whole complex spectrum is multiplied, so no symmetry of the real
input is used.  Everything is complex128 on the input's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def log_scales(low: float, high: float, count: int) -> np.ndarray:
    """``count`` scales log-spaced from ``low`` to ``high``."""
    return np.exp(np.linspace(math.log(low), math.log(high), count))


def morlet_multipliers(padded: int, scales, omega0: float, device,
                       fs: float = 1.0) -> torch.Tensor:
    """(S, P) complex128: conj(√a·ψ̂(a·ω)) on the FFT's frequency grid."""
    fb, fc = 2.0, omega0 / (2.0 * math.pi)
    k = torch.arange(padded, dtype=torch.float64, device=device)
    omega = 2.0 * math.pi * k * fs / padded
    omega = torch.where(k > padded // 2, omega - 2.0 * math.pi * fs, omega)
    a = torch.as_tensor(np.asarray(scales, dtype=np.float64),
                        device=device)[:, None]
    f = a * omega / (2.0 * math.pi)
    psi = math.sqrt(2.0 * math.pi * fb) * torch.exp(
        -2.0 * math.pi ** 2 * fb * (f - fc) ** 2)
    return (torch.sqrt(a) * psi).to(torch.complex128).conj()


def cwt(x: torch.Tensor, scales, omega0: float,
        rows_per_block: int = 8) -> torch.Tensor:
    """(B, S, n) complex128 coefficients of the (B, n) signals ``x``,
    ``rows_per_block`` signals at a time."""
    n = x.shape[-1]
    padded = 1 << (n - 1).bit_length()
    mult = morlet_multipliers(padded, scales, omega0, x.device)
    out = []
    for i in range(0, x.shape[0], rows_per_block):
        xs = torch.nn.functional.pad(x[i:i + rows_per_block].double(),
                                     (0, padded - n))
        spec = torch.fft.fft(xs.to(torch.complex128), dim=-1)
        out.append(torch.fft.ifft(spec[:, None, :] * mult,
                                  dim=-1)[..., :n])
    return torch.cat(out)
