from .base import (
    DiscreteWavelet, from_jax_wavelet, qmf_biorthogonal, qmf_orthonormal,
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
]
