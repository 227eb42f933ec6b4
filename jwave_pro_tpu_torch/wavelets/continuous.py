"""Continuous wavelets: Morlet, Mexican Hat, Paul, DOG, Meyer.

Counterpart of ``jwave_pro_tpu/wavelets/continuous.py``; same classes,
parameters and formulas (``wavelets/continuous/*.java`` of the reference).
Each wavelet exposes ψ(t) and ψ̂(ω) as vectorized torch functions — a
tensor in, a complex tensor out on its device; a Python number or numpy
array is read as float64 on the host — plus admissibility constant,
effective support and bandwidth.  The base class applies the scaling laws
(``ContinuousWavelet.java:79-145``):

    ψ_{a,b}(t)      = ψ((t-b)/a) / √a
    ψ̂_{a,b}(ω)      = √a · e^{-iωb} · ψ̂(a·ω)

Wavelets are frozen, hashable dataclasses of Python floats, so the CWT
caches its host-side multipliers per wavelet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "ContinuousWavelet", "MorletWavelet", "MexicanHatWavelet", "PaulWavelet",
    "DOGWavelet", "MeyerWavelet", "continuous_wavelet",
    "from_jax_continuous",
]


def _real(x) -> torch.Tensor:
    """``x`` as a real floating tensor (float64 for host numbers)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() or x.is_complex() else x.double()
    return torch.as_tensor(x, dtype=torch.float64)


def _scale_like(scale, like: torch.Tensor) -> torch.Tensor:
    """``scale`` as a tensor of ``like``'s real dtype on its device, as
    ``jnp.asarray(scale, jnp.result_type(like, float))``."""
    dtype = like.real.dtype if like.is_complex() else like.dtype
    return torch.as_tensor(scale, dtype=dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class ContinuousWavelet:
    """Base: analytic ψ(t)/ψ̂(ω) + scaled variants
    (ContinuousWavelet.java:35-167)."""

    name: str = "continuous"
    center_frequency: float = 1.0

    # -- to implement per family -------------------------------------------
    def psi(self, t):
        raise NotImplementedError

    def psi_hat(self, omega):
        raise NotImplementedError

    def admissibility_constant(self) -> float:
        raise NotImplementedError

    def effective_support(self) -> tuple[float, float]:
        raise NotImplementedError

    def bandwidth(self) -> tuple[float, float]:
        raise NotImplementedError

    # -- scaling laws -------------------------------------------------------
    def psi_scaled(self, t, scale, translation=0.0):
        """ψ_{a,b}(t) = ψ((t−b)/a)/√a (ContinuousWavelet.java:90-102)."""
        t = _real(t)
        return self.psi((t - translation) / scale) / torch.sqrt(
            _scale_like(scale, t))

    def psi_hat_scaled(self, omega, scale, translation=0.0):
        """√a·e^{−iωb}·ψ̂(aω) (ContinuousWavelet.java:121-145)."""
        omega = _real(omega)
        ft = self.psi_hat(scale * omega) * torch.sqrt(
            _scale_like(scale, omega))
        if translation:
            ft = ft * torch.exp(-1j * omega * translation)
        return ft

    def scale_to_frequency(self, scale, sampling_rate=1.0):
        """f = fc·fs/a (CWTResult.java:185-197)."""
        return self.center_frequency * sampling_rate / scale


@dataclasses.dataclass(frozen=True, repr=False)
class MorletWavelet(ContinuousWavelet):
    """Complex Morlet: ψ(t) = (2π·fb)^{-1/2} e^{2πi·fc·t} e^{−t²/(2fb)}.

    Parity: ``MorletWavelet.java:90-125`` (fb = bandwidth, fc = center
    frequency; defaults fb=fc=1, ``:56-58``).  ``from_omega0`` maps the
    Torrence–Compo ω₀ convention (e.g. Morlet(6.0)) onto (fb, fc).
    """

    fb: float = 1.0
    fc: float = 1.0

    def __init__(self, fb: float = 1.0, fc: float = 1.0):
        if fb <= 0 or fc <= 0:
            raise ValueError("fb and fc must be positive")
        object.__setattr__(self, "fb", float(fb))
        object.__setattr__(self, "fc", float(fc))
        object.__setattr__(self, "name", "Morlet")
        object.__setattr__(self, "center_frequency", float(fc))

    @classmethod
    def from_omega0(cls, omega0: float = 6.0):
        """Torrence–Compo Morlet(ω₀): fc = ω₀/(2π), fb = 2 (σ_t=1 Gaussian)."""
        return cls(fb=2.0, fc=omega0 / (2.0 * math.pi))

    def psi(self, t):
        t = _real(t)
        norm = 1.0 / math.sqrt(2.0 * math.pi * self.fb)
        env = torch.exp(-(t * t) / (2.0 * self.fb))
        phase = 2.0 * math.pi * self.fc * t
        return norm * env * (torch.cos(phase) + 1j * torch.sin(phase))

    def psi_hat(self, omega):
        f = _real(omega) / (2.0 * math.pi)
        norm = math.sqrt(2.0 * math.pi * self.fb)
        val = norm * torch.exp(
            -2.0 * math.pi ** 2 * self.fb * (f - self.fc) ** 2)
        return val + 0j

    def admissibility_constant(self):
        return 2.0 * math.pi * (1.1 if self.fc < 0.8 else 1.0)

    def effective_support(self):
        r = 4.0 * math.sqrt(self.fb)
        return (-r, r)

    def bandwidth(self):
        hw = 2.0 / math.sqrt(2.0 * math.pi * self.fb)
        return (self.fc - hw, self.fc + hw)


@dataclasses.dataclass(frozen=True, repr=False)
class MexicanHatWavelet(ContinuousWavelet):
    """Ricker: ψ(t) = C(1−(t/σ)²)e^{−t²/(2σ²)}
    (MexicanHatWavelet.java:64-120)."""

    sigma: float = 1.0

    def __init__(self, sigma: float = 1.0):
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        object.__setattr__(self, "sigma", float(sigma))
        object.__setattr__(self, "name", "Mexican Hat (Ricker)")
        object.__setattr__(self, "center_frequency",
                           1.0 / (2.0 * math.pi * sigma))

    @property
    def _norm(self):
        return 2.0 / (math.sqrt(3.0 * self.sigma) * math.pi ** 0.25)

    @classmethod
    def from_center_frequency(cls, fc: float):
        """σ = 1/(2π·fc) (MexicanHatWavelet.java:175-186)."""
        return cls(1.0 / (2.0 * math.pi * fc))

    def psi(self, t):
        tn = _real(t) / self.sigma
        tn2 = tn * tn
        return (self._norm * (1.0 - tn2) * torch.exp(-0.5 * tn2)) + 0j

    def psi_hat(self, omega):
        omega = _real(omega)
        ft_norm = self._norm * self.sigma * math.sqrt(2.0 * math.pi)
        w2 = omega * omega
        return (ft_norm * w2
                * torch.exp(-0.5 * self.sigma ** 2 * w2)) + 0j

    def admissibility_constant(self):
        return math.pi

    def effective_support(self):
        return (-5.0 * self.sigma, 5.0 * self.sigma)

    def bandwidth(self):
        return (0.0, 3.0 / (2.0 * math.pi * self.sigma))


@dataclasses.dataclass(frozen=True, repr=False)
class PaulWavelet(ContinuousWavelet):
    """Paul order m: ψ(t) = C·iᵐ(1−it)^{−(m+1)}; analytic (ω>0 only).

    Parity: ``PaulWavelet.java:75-160`` — ψ̂(ω) = √(2π)·ωᵐ·e^{−ω}·H(ω)
    (the reference's ψ̂ omits the time-domain norm constant; mirrored).
    """

    m: int = 4

    def __init__(self, m: int = 4):
        if not (1 <= m <= 20):
            raise ValueError("order m must be in [1, 20]")
        object.__setattr__(self, "m", int(m))
        object.__setattr__(self, "name", "Paul")
        object.__setattr__(self, "center_frequency",
                           (m + 0.5) / (2.0 * math.pi))

    @property
    def _norm(self):
        return (2.0 ** self.m * math.factorial(self.m)
                / math.sqrt(math.pi * math.factorial(2 * self.m)))

    def psi(self, t):
        one_minus_it = 1.0 - 1j * _real(t)
        power = one_minus_it ** (-(self.m + 1))
        return self._norm * (1j ** self.m) * power

    def psi_hat(self, omega):
        omega = _real(omega)
        pos = omega > 0
        safe = torch.where(pos, omega, 1.0)
        val = math.sqrt(2.0 * math.pi) * safe ** self.m * torch.exp(-safe)
        return torch.where(pos, val, 0.0) + 0j

    def admissibility_constant(self):
        return 2.0 * math.pi / (2 * self.m + 1)

    def effective_support(self):
        return (-1.0, 2.0 * (self.m + 1))

    def bandwidth(self):
        # Peak at ω=m; significant range ~[m/3, 3m] (PaulWavelet.java:200-210)
        return (self.m / 3.0 / (2.0 * math.pi), 3.0 * self.m / (2.0 * math.pi))


def _hermite_coeffs(n: int):
    """Physicists' Hermite Hₙ coefficients via the standard recurrence."""
    coeffs = [[1.0], [0.0, 2.0]]
    for k in range(2, n + 1):
        prev, prev2 = coeffs[k - 1], coeffs[k - 2]
        c = [0.0] * (k + 1)
        for i in range(1, k + 1):
            if i - 1 < len(prev):
                c[i] += 2.0 * prev[i - 1]
        for i in range(0, k - 1):
            c[i] -= 2.0 * (k - 1) * prev2[i]
        coeffs.append(c)
    return coeffs[n]


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


@dataclasses.dataclass(frozen=True, repr=False)
class DOGWavelet(ContinuousWavelet):
    """Derivative-of-Gaussian order n: ψ(t) = C·Hₙ(t/σ)e^{−t²/(2σ²)}.

    Parity: ``DOGWavelet.java:128-262`` — ψ̂(ω) = C·iⁿ·√(2π)·σ^{n+1}·|ω|ⁿ·
    e^{−σ²ω²/2} with iⁿ phase per n mod 4 (``:187-217``), L2 norm constant
    √((2n−1)!!/(2ⁿ√π σ^{2n+1})) (``:357-367``).  n=2 is the Mexican Hat.
    """

    n: int = 2
    sigma: float = 1.0

    def __init__(self, n: int = 2, sigma: float = 1.0):
        if not (1 <= n <= 10):
            raise ValueError("derivative order n must be in [1, 10]")
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "sigma", float(sigma))
        object.__setattr__(self, "name", f"DOG (n={n})")
        object.__setattr__(self, "center_frequency",
                           math.sqrt(n) / (2.0 * math.pi * sigma))

    #: preset derivative orders (``DOGWavelet.java:56-76`` WaveletType enum)
    STANDARD_TYPES = {
        "edge": (1, "Edge detection"),
        "mexican_hat": (2, "Mexican Hat / Ricker wavelet"),
        "ricker": (2, "Ricker wavelet (alias for Mexican Hat)"),
        "zero_crossing": (3, "Zero-crossing detection"),
        "ridge": (4, "Ridge detection"),
    }

    @classmethod
    def standard(cls, kind: str, sigma: float = 1.0) -> "DOGWavelet":
        """Preset factory: ``DOGWavelet.java:401-406`` ``createStandard``.

        ``kind`` ∈ 'edge' (n=1), 'mexican_hat'/'ricker' (n=2),
        'zero_crossing' (n=3), 'ridge' (n=4); case-insensitive.
        """
        try:
            n, _ = cls.STANDARD_TYPES[str(kind).lower()]
        except KeyError:
            raise ValueError(
                f"unknown DOG preset {kind!r}; one of "
                f"{sorted(cls.STANDARD_TYPES)}") from None
        return cls(n, sigma)

    @property
    def _norm(self):
        return math.sqrt(_double_factorial(2 * self.n - 1)
                         / (2.0 ** self.n * math.sqrt(math.pi)
                            * self.sigma ** (2 * self.n + 1)))

    def psi(self, t):
        x = _real(t) / self.sigma
        h = torch.zeros_like(x)
        for c in reversed(_hermite_coeffs(self.n)):
            h = h * x + c
        return (self._norm * h * torch.exp(-0.5 * x * x)) + 0j

    def psi_hat(self, omega):
        omega = _real(omega)
        mag = (self._norm * math.sqrt(2.0 * math.pi)
               * self.sigma ** (self.n + 1)
               * torch.abs(omega) ** self.n
               * torch.exp(-0.5 * self.sigma ** 2 * omega * omega))
        r = self.n % 4
        if r == 0:
            return mag + 0j
        if r == 1:
            return 1j * mag * torch.sign(omega)
        if r == 2:
            return -mag + 0j
        return -1j * mag * torch.sign(omega)

    def admissibility_constant(self):
        return 2.0 * math.pi

    def effective_support(self):
        r = (3.0 + self.n / 2.0) * self.sigma
        return (-r, r)

    def bandwidth(self):
        return (0.0, (1.0 + self.n / 2.0) / (2.0 * math.pi * self.sigma))


@dataclasses.dataclass(frozen=True, repr=False)
class MeyerWavelet(ContinuousWavelet):
    """Meyer: compactly supported in frequency on [2π/3, 8π/3].

    Parity: ``MeyerWavelet.java:170-331`` — sin/cos branches with ν(x) =
    x⁴(35−84x+70x²−20x³), √(2π) normalization, e^{iω/2} phase; the
    time-domain ψ is the reference's harmonic sinc approximation
    (``:180-210``).
    """

    def __init__(self):
        object.__setattr__(self, "name", "Meyer")
        object.__setattr__(self, "center_frequency", 0.7 / (2.0 * math.pi))

    @staticmethod
    def _nu(x):
        x = torch.clamp(x, 0.0, 1.0)
        return x ** 4 * (35.0 + x * (-84.0 + x * (70.0 - 20.0 * x)))

    def psi(self, t):
        t = _real(t)
        decay, w0 = 25.0, 0.7
        env = torch.exp(-0.5 * t * t / decay)

        def sinc(x):
            return torch.sinc(x / math.pi)  # normalized sin(πx)/(πx)

        val = w0 * sinc(w0 * t) * env
        val = val + 0.2 * (1.4 * w0) * sinc(1.4 * w0 * t) * env
        val = val + (-0.1) * (0.5 * w0) * sinc(0.5 * w0 * t) * env
        val = val * math.sqrt(2.0 / math.pi)
        val = torch.where(torch.abs(t) > 15.0, 0.0, val)
        return val + 0j

    def psi_hat(self, omega):
        omega = _real(omega)
        aw = torch.abs(omega)
        lo, mid, hi = (2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0,
                       8.0 * math.pi / 3.0)
        sin_b = torch.sin(math.pi / 2.0
                          * self._nu(3.0 * aw / (2.0 * math.pi) - 1.0))
        cos_b = torch.cos(math.pi / 2.0
                          * self._nu(3.0 * aw / (4.0 * math.pi) - 1.0))
        val = torch.where((aw >= lo) & (aw <= mid), sin_b,
                          torch.where((aw > mid) & (aw <= hi), cos_b, 0.0))
        val = val * math.sqrt(2.0 * math.pi)
        phase = omega / 2.0
        return val * (torch.cos(phase) + 1j * torch.sin(phase))

    def admissibility_constant(self):
        return 2.0 * math.pi

    def effective_support(self):
        return (-15.0, 15.0)

    def bandwidth(self):
        return (2.0 / 3.0 / (2.0 * math.pi), 8.0 / 3.0 / (2.0 * math.pi))


_CONTINUOUS = {
    "morlet": MorletWavelet,
    "mexican hat": MexicanHatWavelet,
    "mexican hat (ricker)": MexicanHatWavelet,
    "ricker": MexicanHatWavelet,
    "paul": PaulWavelet,
    "dog": DOGWavelet,
    "meyer": MeyerWavelet,
}

# each family's constructor parameters, as its dataclass fields
_PARAMS = {MorletWavelet: ("fb", "fc"), MexicanHatWavelet: ("sigma",),
           PaulWavelet: ("m",), DOGWavelet: ("n", "sigma"),
           MeyerWavelet: ()}


def continuous_wavelet(name: str, *args, **kwargs) -> ContinuousWavelet:
    """Factory by name ('morlet', 'mexican hat', 'paul', 'dog', 'meyer')."""
    key = name.strip().lower()
    if key not in _CONTINUOUS:
        raise ValueError(f"unknown continuous wavelet {name!r}: "
                         f"{sorted(_CONTINUOUS)}")
    return _CONTINUOUS[key](*args, **kwargs)


def from_jax_continuous(w):
    """This package's continuous wavelet (1D, or 2D from
    ``continuous2d.py``) built from a ``jwave_pro_tpu`` one of the same
    family (its class name), with the same parameters read by attribute —
    so this module never imports JAX."""
    from .continuous2d import _PARAMS_2D

    for cls, params in (*_PARAMS.items(), *_PARAMS_2D.items()):
        if type(w).__name__ == cls.__name__:
            return cls(*(getattr(w, p) for p in params))
    raise ValueError(f"no continuous wavelet family {type(w).__name__!r}")
