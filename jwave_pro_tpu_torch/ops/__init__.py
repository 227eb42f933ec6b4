from .denoise import (
    bayes_threshold, hard_threshold, mad_sigma, modwt_denoise,
    modwt_denoise_inplace, soft_threshold, sure_threshold,
    universal_threshold,
)
from .modwt import (
    MAX_DECOMPOSITION_LEVEL, circular_convolve, circular_convolve_adjoint,
    imodwt, modwt, modwt_base_filters, modwt_mra,
)

__all__ = [
    "modwt", "imodwt", "modwt_mra", "modwt_base_filters",
    "MAX_DECOMPOSITION_LEVEL", "circular_convolve",
    "circular_convolve_adjoint",
    "soft_threshold", "hard_threshold", "mad_sigma", "universal_threshold",
    "sure_threshold", "bayes_threshold", "modwt_denoise",
    "modwt_denoise_inplace",
]
