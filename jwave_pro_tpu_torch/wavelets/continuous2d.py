"""2D continuous wavelets: isotropic Mexican Hat (LoG) and directional Morlet.

Counterpart of ``jwave_pro_tpu/wavelets/continuous2d.py``; same classes,
parameters and formulas.  The reference is 1D-only (its CWT tier,
``jwave/transforms/ContinuousWaveletTransform.java``, has no 2D analog);
this follows the Antoine–Murenzi 2D CWT conventions:

    ψ_{a,θ,b}(x) = a⁻¹ · ψ(r_{−θ}(x−b)/a)          (L2-preserving, 2D: 1/a)
    ψ̂_{a,θ}(k)   = a · ψ̂(a·r_{−θ}k)

with r_θ the plane rotation.  Fourier convention ψ̂(k) = ∫ψ(x)e^{−ik·x}d²x,
as in the 1D tier (``continuous.py``).  ψ and ψ̂ are torch functions — a
tensor in, a complex tensor out on its device; a Python number or numpy
array is read as float64 on the host.  Wavelets are frozen, hashable
dataclasses of Python floats, so the 2D CWT caches its multipliers per
wavelet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .continuous import _real

__all__ = [
    "ContinuousWavelet2D", "MexicanHat2D", "Morlet2D",
    "continuous_wavelet2d",
]


@dataclasses.dataclass(frozen=True)
class ContinuousWavelet2D:
    """Base: analytic ψ(x,y) / ψ̂(kx,ky) + rotation/scaling laws."""

    name: str = "continuous2d"
    #: True when the family has an orientation axis worth sweeping.
    directional: bool = False
    #: True when ψ̂ is real and even → CWT of a real image is real.
    real_even_hat: bool = False

    def psi(self, x, y):
        raise NotImplementedError

    def psi_hat(self, kx, ky):
        raise NotImplementedError

    # -- scaling/rotation laws (Antoine–Murenzi) ----------------------------
    def psi_scaled(self, x, y, scale, angle=0.0):
        """a⁻¹·ψ(r_{−θ}(x,y)/a): unit-L2 dilation + rotation by θ."""
        x, y = _real(x), _real(y)
        c, s = math.cos(angle), math.sin(angle)
        u = (c * x + s * y) / scale
        v = (-s * x + c * y) / scale
        return self.psi(u, v) / scale

    def psi_hat_scaled(self, kx, ky, scale, angle=0.0):
        """a·ψ̂(a·r_{−θ}k) — the FFT-path multiplier building block."""
        kx, ky = _real(kx), _real(ky)
        c, s = math.cos(angle), math.sin(angle)
        u = scale * (c * kx + s * ky)
        v = scale * (-s * kx + c * ky)
        return self.psi_hat(u, v) * scale


@dataclasses.dataclass(frozen=True, repr=False)
class MexicanHat2D(ContinuousWavelet2D):
    """Isotropic 2D Mexican Hat (negative Laplacian-of-Gaussian).

    ψ(x) = (σ√(2π))⁻¹·(2 − r²/σ²)·e^{−r²/(2σ²)},  r² = x²+y²
    ψ̂(k) = √(2π)·σ³·|k|²·e^{−σ²|k|²/2}

    Unit L2 norm; real-even ψ̂, so the coefficients of a real image are
    real (the 2D CWT's rfft2 path).
    """

    sigma: float = 1.0

    def __init__(self, sigma: float = 1.0):
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        object.__setattr__(self, "sigma", float(sigma))
        object.__setattr__(self, "name", "Mexican Hat 2D")
        object.__setattr__(self, "directional", False)
        object.__setattr__(self, "real_even_hat", True)

    @property
    def _norm(self):
        return 1.0 / (self.sigma * math.sqrt(2.0 * math.pi))

    def psi(self, x, y):
        x, y = _real(x), _real(y)
        r2 = (x * x + y * y) / (self.sigma * self.sigma)
        return self._norm * (2.0 - r2) * torch.exp(-0.5 * r2)

    def psi_hat(self, kx, ky):
        kx, ky = _real(kx), _real(ky)
        k2 = kx * kx + ky * ky
        # norm·2π·σ⁴·|k|²·e^{−σ²|k|²/2} = √(2π)·σ³·|k|²·e^{−σ²|k|²/2}
        return (self._norm * 2.0 * math.pi * self.sigma ** 4 * k2
                * torch.exp(-0.5 * self.sigma ** 2 * k2)) + 0j


@dataclasses.dataclass(frozen=True, repr=False)
class Morlet2D(ContinuousWavelet2D):
    """Directional 2D Morlet: a plane wave along +x under a Gaussian.

    ψ(x) = π^{−1/2}·e^{i·k0·x₁}·e^{−r²/2}
    ψ̂(k) = π^{−1/2}·2π·e^{−|k − k0·e₁|²/2}

    Unit L2 norm.  The admissibility correction e^{−k0²/2} is omitted
    (below 4e-6 of the peak for k0 ≥ 5; the default k0 = 5.5 keeps that
    regime).  Rotating by θ points the passband along direction θ.
    """

    k0: float = 5.5

    def __init__(self, k0: float = 5.5):
        if k0 <= 0:
            raise ValueError("k0 must be positive")
        object.__setattr__(self, "k0", float(k0))
        object.__setattr__(self, "name", "Morlet 2D")
        object.__setattr__(self, "directional", True)
        object.__setattr__(self, "real_even_hat", False)

    def psi(self, x, y):
        x, y = _real(x), _real(y)
        r2 = x * x + y * y
        env = torch.exp(-0.5 * r2) / math.sqrt(math.pi)
        phase = self.k0 * x
        return env * (torch.cos(phase) + 1j * torch.sin(phase))

    def psi_hat(self, kx, ky):
        kx, ky = _real(kx), _real(ky)
        d2 = (kx - self.k0) ** 2 + ky * ky
        return (2.0 * math.sqrt(math.pi)) * torch.exp(-0.5 * d2) + 0j


_CONTINUOUS_2D = {
    "mexican hat 2d": MexicanHat2D,
    "mexican hat": MexicanHat2D,
    "ricker 2d": MexicanHat2D,
    "log": MexicanHat2D,
    "morlet 2d": Morlet2D,
    "morlet": Morlet2D,
}

# each family's constructor parameters, read by attribute
_PARAMS_2D = {MexicanHat2D: ("sigma",), Morlet2D: ("k0",)}


def continuous_wavelet2d(name: str, *args, **kwargs) -> ContinuousWavelet2D:
    """Factory by name ('mexican hat 2d' / 'log', 'morlet 2d')."""
    key = name.strip().lower()
    if key not in _CONTINUOUS_2D:
        raise ValueError(f"unknown 2D continuous wavelet {name!r}: "
                         f"{sorted(_CONTINUOUS_2D)}")
    return _CONTINUOUS_2D[key](*args, **kwargs)
