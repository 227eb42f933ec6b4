"""Discrete wavelet filter-bank objects (counterpart of
``jwave_pro_tpu/wavelets/base.py``).

A wavelet is data: four float64 filter banks held as numpy arrays on the
host.  Transforms read them as Python constants; :meth:`DiscreteWavelet.
tensor_banks` keeps a small per-``(device, dtype)`` cache of the same banks
as tensors for code that wants them on a device.

Parity notes (reference = Prophetizo/JWave-Pro):
  * QMF construction from the low-pass decomposition filter mirrors
    ``jwave/transforms/wavelets/Wavelet.java:104-122``.
  * Biorthogonal reconstruction-bank construction mirrors
    ``jwave/transforms/wavelets/biorthogonal/BiOrthogonal.java:28-66``.
  * ``energy_correction`` reproduces the unnormalized-Haar reverse factor
    (``jwave/transforms/wavelets/haar/Haar1Orthogonal.java:165-205``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import tracing

__all__ = [
    "DiscreteWavelet", "qmf_orthonormal", "qmf_biorthogonal",
    "from_jax_wavelet",
]

_BANKS = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")


@dataclasses.dataclass(frozen=True, eq=False)
class DiscreteWavelet:
    """A discrete wavelet: four filter banks + metadata (host-side float64)."""

    name: str
    dec_lo: np.ndarray  # scaling (low-pass) decomposition filter
    dec_hi: np.ndarray  # wavelet (high-pass) decomposition filter
    rec_lo: np.ndarray  # scaling reconstruction filter
    rec_hi: np.ndarray  # wavelet reconstruction filter
    transform_wavelength: int = 2  # minimal input length for one step
    energy_correction: float = 1.0  # multiplies the synthesis step output
    family: str = ""

    def __post_init__(self):
        for f in _BANKS:
            object.__setattr__(
                self, f, np.ascontiguousarray(getattr(self, f), dtype=np.float64)
            )
        object.__setattr__(self, "_tensor_cache", {})

    @property
    def length(self) -> int:
        """Number of taps (the reference's ``_motherWavelength``)."""
        return int(self.dec_lo.shape[0])

    def tensor_banks(self, device=None, dtype=torch.float64):
        """``(dec_lo, dec_hi, rec_lo, rec_hi)`` as tensors, cached per
        ``(device, dtype)`` — at most a few entries per wavelet; none while
        torch traces (its tensors are fakes then)."""
        key = (torch.device(device or "cpu"), dtype)
        banks = self._tensor_cache.get(key)
        if banks is None:
            banks = tuple(torch.as_tensor(getattr(self, f), dtype=dtype,
                                          device=key[0]) for f in _BANKS)
            if not tracing():
                self._tensor_cache[key] = banks
        return banks

    def __repr__(self):  # pragma: no cover
        return f"DiscreteWavelet({self.name!r}, taps={self.length})"

    # Wavelets are static metadata (cache keys), hashed by their taps.
    def __hash__(self):
        return hash((self.name, self.length, self.dec_lo.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, DiscreteWavelet)
            and self.name == other.name
            and all(np.array_equal(getattr(self, f), getattr(other, f))
                    for f in _BANKS)
        )


def qmf_orthonormal(name, dec_lo, *, transform_wavelength=2, family="",
                    dec_hi=None, energy_correction=1.0) -> DiscreteWavelet:
    """Build an orthonormal wavelet from its low-pass decomposition taps.

    High-pass via the quadrature-mirror relation ``hi[i] = ±lo[M-1-i]``
    (sign + on even i), reconstruction banks equal to decomposition banks —
    the reference's ``Wavelet._buildOrthonormalSpace``
    (``Wavelet.java:104-122``).  ``dec_hi`` may be given explicitly for the
    classes that define it directly (both Haar variants).
    """
    lo = np.asarray(dec_lo, dtype=np.float64)
    if dec_hi is None:
        hi = lo[::-1].copy()
        hi[1::2] *= -1.0
    else:
        hi = np.asarray(dec_hi, dtype=np.float64)
    return DiscreteWavelet(
        name=name, dec_lo=lo, dec_hi=hi, rec_lo=lo.copy(), rec_hi=hi.copy(),
        transform_wavelength=transform_wavelength,
        energy_correction=energy_correction, family=family,
    )


def qmf_biorthogonal(name, dec_lo, dec_hi, *, transform_wavelength=2,
                     family="biorthogonal") -> DiscreteWavelet:
    """Build a biorthogonal wavelet from both decomposition banks.

    Reconstruction banks via the reference's alternating-sign swap
    (``BiOrthogonal.java:44-66``): on even i ``rec_lo[i] = -dec_hi[i]``,
    ``rec_hi[i] = -dec_lo[i]``; on odd i the unnegated swap.
    """
    lo = np.asarray(dec_lo, dtype=np.float64)
    hi = np.asarray(dec_hi, dtype=np.float64)
    rec_lo = hi.copy()
    rec_hi = lo.copy()
    rec_lo[0::2] *= -1.0
    rec_hi[0::2] *= -1.0
    return DiscreteWavelet(
        name=name, dec_lo=lo, dec_hi=hi, rec_lo=rec_lo, rec_hi=rec_hi,
        transform_wavelength=transform_wavelength, family=family,
    )


def from_jax_wavelet(w):
    """This package's wavelet built from a ``jwave_pro_tpu`` wavelet.

    A discrete wavelet's parameters are its four filter banks; carrying them
    (and the metadata) across makes both packages compute the same
    transform.  A continuous wavelet (no filter banks) becomes this
    package's wavelet of the same family and parameters
    (:func:`.continuous.from_jax_continuous`).  ``w`` is read by attribute
    only, so this module never imports JAX.
    """
    if not hasattr(w, "dec_lo"):
        from .continuous import from_jax_continuous

        return from_jax_continuous(w)
    return DiscreteWavelet(
        name=w.name,
        **{f: np.asarray(getattr(w, f), dtype=np.float64) for f in _BANKS},
        transform_wavelength=int(w.transform_wavelength),
        energy_correction=float(w.energy_correction),
        family=str(w.family),
    )
