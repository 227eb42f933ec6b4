"""jwave_pro_tpu_torch — the PyTorch + CUDA port of ``jwave_pro_tpu``.

This slice holds the MODWT forward → shrink → inverse path: the wavelet
registry, ``modwt``/``imodwt``/``modwt_mra``, the 1D denoise, and the
hand-written CUDA kernels behind them (``kernels/``, built from ``csrc/``
with ``nvcc`` on first launch).  Names and signatures match the JAX package;
tensors stay on the device they arrive on.  Importing this package never
imports JAX or ``jwave_pro_tpu``.

    import jwave_pro_tpu_torch as jt
    w = jt.wavelet("Daubechies 4")
    c = jt.modwt(x, w, 5)            # (6, B, N)
    y = jt.modwt_denoise(x, w, 5, method="fused")
"""
from .exceptions import JWaveException, JWaveFailure, NotKnown
from .ops import (
    MAX_DECOMPOSITION_LEVEL, bayes_threshold, circular_convolve,
    circular_convolve_adjoint, hard_threshold, imodwt, mad_sigma, modwt,
    modwt_base_filters, modwt_denoise, modwt_denoise_inplace, modwt_mra,
    soft_threshold, sure_threshold, universal_threshold,
)
from .utils import time_chain
from .wavelets import (
    REGISTRY, DiscreteWavelet, biorthogonal, coiflet, daubechies,
    from_jax_wavelet, good_wavelets, legendre, qmf_biorthogonal,
    qmf_orthonormal, symlet, wavelet, wavelet_names,
)

__all__ = [
    "JWaveException", "JWaveFailure", "NotKnown", "DiscreteWavelet", "from_jax_wavelet", "qmf_orthonormal",
    "qmf_biorthogonal", "REGISTRY", "wavelet", "wavelet_names",
    "good_wavelets", "daubechies", "symlet", "coiflet", "biorthogonal",
    "legendre",
    "modwt", "imodwt", "modwt_mra", "modwt_base_filters",
    "MAX_DECOMPOSITION_LEVEL", "circular_convolve",
    "circular_convolve_adjoint",
    "soft_threshold", "hard_threshold", "mad_sigma", "universal_threshold",
    "sure_threshold", "bayes_threshold", "modwt_denoise",
    "modwt_denoise_inplace",
    "time_chain",
]
