"""Wavelet registry: name → :class:`DiscreteWavelet` (counterpart of
``jwave_pro_tpu/wavelets/families.py``).

Mirrors the reference's string factory ``WaveletBuilder.create(name)``
(``jwave/transforms/wavelets/WaveletBuilder.java:99-403``) including its exact
name strings, plus short PyWavelets-style aliases ("db4", "sym8", "bior3.5",
"coif2", "haar", ...).

The tap table is the port's own ``_taps.py`` beside this module: pure data
(one ``TAPS`` dict, no imports), a copy of the JAX package's table, so the
port reads no file of the JAX package.

``good_wavelets()`` mirrors ``WaveletBuilder.create2arr()``
(``WaveletBuilder.java:427-504``).  The reference's builder throws for
"Battle 23", "CDF 5/3" and "CDF 9/7" (``WaveletBuilder.java:363-385``); they
are constructible via ``wavelet(name, unsafe=True)`` only.
"""
from __future__ import annotations

import numpy as np

from ..exceptions import NotKnown
from ._taps import TAPS
from .base import DiscreteWavelet, qmf_biorthogonal, qmf_orthonormal

__all__ = ["wavelet", "wavelet_names", "good_wavelets", "REGISTRY"]

# Java classes the reference's WaveletBuilder refuses to build (throws
# JWaveFailure, WaveletBuilder.java:363-385).
_BUILDER_REJECTED = {"Battle23", "CDF53", "CDF97"}

# Names excluded from WaveletBuilder.create2arr() (WaveletBuilder.java:427-504).
_NOT_PR_SAFE = {
    "Legendre 1", "Legendre 2", "Legendre 3",
    "BiOrthogonal 2/2", "BiOrthogonal 2/4", "BiOrthogonal 2/6",
    "BiOrthogonal 2/8", "BiOrthogonal 4/4", "BiOrthogonal 5/5",
    "BiOrthogonal 6/8", "Discrete Meyer",
}


def _build(entry) -> DiscreteWavelet:
    """Construct a wavelet the way its reference constructor does.

    Three construction modes observed in the reference classes:
      * 'orthonormal' — only dec_lo given, then ``_buildOrthonormalSpace``
        (``Wavelet.java:104-122``), e.g. all Daubechies/Symlets/Coiflets;
      * 'biorthogonal' — dec_lo+dec_hi given, then
        ``_buildBiOrthonormalSpace`` (``BiOrthogonal.java:44-66``);
      * 'explicit' — recon banks hardcoded (BiOrthogonal 1/1, 1/3, 2/2, 5/5)
        or loop-copied from the decomposition banks (both Haars,
        CDF 5/3 + 9/7, e.g. ``other/CDF53.java:68-73``).
    """
    name = entry["name"]
    fam = entry["family"]
    lo = np.asarray(entry["dec_lo"], dtype=np.float64)
    twl = entry["transform_wavelength"]
    builder = entry.get("builder", "orthonormal")
    energy = 0.5 if entry.get("java_class") == "Haar1Orthogonal" else 1.0
    if builder == "biorthogonal":
        return qmf_biorthogonal(
            name, lo, np.asarray(entry["dec_hi"], dtype=np.float64),
            transform_wavelength=twl, family=fam,
        )
    if builder == "explicit" and "dec_hi" not in entry:
        # Battle23 inlines the orthonormal construction by hand
        # (other/Battle23.java:79-93) — identical to the QMF builder.
        return qmf_orthonormal(name, lo, transform_wavelength=twl,
                               family=fam, energy_correction=energy)
    if builder == "explicit" or "rec_lo" in entry:
        hi = np.asarray(entry["dec_hi"], dtype=np.float64)
        rec_lo = np.asarray(entry.get("rec_lo", entry["dec_lo"]), np.float64)
        rec_hi = np.asarray(entry.get("rec_hi", entry["dec_hi"]), np.float64)
        return DiscreteWavelet(
            name=name, dec_lo=lo, dec_hi=hi, rec_lo=rec_lo, rec_hi=rec_hi,
            transform_wavelength=twl, energy_correction=energy, family=fam,
        )
    return qmf_orthonormal(
        name, lo, transform_wavelength=twl, family=fam,
        energy_correction=energy,
    )


def _make_registry():
    reg = {}
    rejected = {}
    for cls, entry in TAPS.items():
        entry = dict(entry)
        entry["java_class"] = cls
        w = _build(entry)
        if cls in _BUILDER_REJECTED:
            rejected[w.name] = w
        else:
            reg[w.name] = w
    return reg, rejected


REGISTRY, _REJECTED = _make_registry()

# Short aliases (PyWavelets-style) → reference names.
_ALIASES = {"haar": "Haar", "haar orthogonal": "Haar orthogonal",
            "dmey": "Discrete Meyer", "battle23": "Battle 23"}
for _n in range(2, 21):
    _ALIASES[f"db{_n}"] = f"Daubechies {_n}"
    _ALIASES[f"sym{_n}"] = f"Symlet {_n}"
_ALIASES["db1"] = "Haar"
for _n in range(1, 6):
    _ALIASES[f"coif{_n}"] = f"Coiflet {_n}"
for _n in range(1, 4):
    _ALIASES[f"leg{_n}"] = f"Legendre {_n}"
for _p, _q in ("11", "13", "15", "22", "24", "26", "28", "31", "33", "35",
               "37", "39", "44", "55", "68"):
    _ALIASES[f"bior{_p}.{_q}"] = f"BiOrthogonal {_p}/{_q}"
_ALIASES["cdf5/3"] = "CDF 5/3"
_ALIASES["cdf9/7"] = "CDF 9/7"


def wavelet(name, *, unsafe: bool = False) -> DiscreteWavelet:
    """Look up a discrete wavelet by reference name or short alias.

    Raises ``ValueError`` for unknown names and — matching the reference
    builder's refusal (``WaveletBuilder.java:363-385``) — for "Battle 23",
    "CDF 5/3" and "CDF 9/7" unless ``unsafe=True``.
    """
    if isinstance(name, DiscreteWavelet):
        return name
    key = _ALIASES.get(name.lower(), name)
    if key in REGISTRY:
        return REGISTRY[key]
    if key in _REJECTED:
        if unsafe:
            return _REJECTED[key]
        raise ValueError(
            f"Wavelet {name!r} is not supported by the stride-2 transform "
            "algorithm (odd tap count); pass unsafe=True to build it anyway. "
            "[parity: WaveletBuilder.java:363-385 throws here]"
        )
    raise NotKnown(f"Unknown wavelet {name!r}. Known: {sorted(REGISTRY)}")


def wavelet_names(include_rejected: bool = False):
    names = sorted(REGISTRY)
    if include_rejected:
        names += sorted(_REJECTED)
    return names


def good_wavelets():
    """All wavelets passing perfect-reconstruction tests (create2arr analog)."""
    return [w for n, w in sorted(REGISTRY.items()) if n not in _NOT_PR_SAFE]


# -- family helpers (API sugar) ---------------------------------------------

def daubechies(n: int) -> DiscreteWavelet:
    """Daubechies N (2N taps), N in 2..20; N=1 is Haar."""
    return wavelet("Haar") if n == 1 else wavelet(f"Daubechies {n}")


def symlet(n: int) -> DiscreteWavelet:
    return wavelet(f"Symlet {n}")


def coiflet(n: int) -> DiscreteWavelet:
    return wavelet(f"Coiflet {n}")


def biorthogonal(p: int, q: int) -> DiscreteWavelet:
    return wavelet(f"BiOrthogonal {p}/{q}")


def legendre(n: int) -> DiscreteWavelet:
    return wavelet(f"Legendre {n}")
