from .base import (
    DiscreteWavelet, from_jax_wavelet, qmf_biorthogonal, qmf_orthonormal,
)
from .continuous import (
    ContinuousWavelet, DOGWavelet, MexicanHatWavelet, MeyerWavelet,
    MorletWavelet, PaulWavelet, continuous_wavelet, from_jax_continuous,
)
from .continuous2d import (
    ContinuousWavelet2D, MexicanHat2D, Morlet2D, continuous_wavelet2d,
)
from .families import (
    REGISTRY, biorthogonal, coiflet, daubechies, good_wavelets, legendre,
    symlet, wavelet, wavelet_names,
)

__all__ = [
    "DiscreteWavelet", "from_jax_wavelet", "qmf_biorthogonal",
    "qmf_orthonormal", "REGISTRY", "good_wavelets", "wavelet",
    "wavelet_names", "daubechies", "symlet", "coiflet", "biorthogonal",
    "legendre",
    "ContinuousWavelet", "MorletWavelet", "MexicanHatWavelet",
    "PaulWavelet", "DOGWavelet", "MeyerWavelet", "continuous_wavelet",
    "from_jax_continuous",
    "ContinuousWavelet2D", "MexicanHat2D", "Morlet2D",
    "continuous_wavelet2d",
]
