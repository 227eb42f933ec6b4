from .analysis import (
    WTCResult, envelope, hilbert, instantaneous_frequency, wavelet_coherence,
)
from .arbitrary import aed_forward, aed_inverse, swt_forward, swt_inverse
from .compress import (
    compress_fixed, compress_magnitude, compress_peaks_average,
    compression_rate,
)
from .cwt import (
    CWTResult, cwt, cwt_direct, generate_linear_scales, generate_log_scales,
    icwt, pad_signal,
)
from .cwt2d import CWT2Result, cwt2, icwt2
from .cwt_banded import (
    band_plan, banded_supported, cwt_banded_coefficients, cwt_banded_wd,
)
from .denoise import (
    bayes_threshold, hard_threshold, mad_sigma, modwt2_denoise,
    modwt3_denoise, modwt_denoise, modwt_denoise_inplace, soft_threshold,
    sure_threshold, universal_threshold, wpt2_denoise, wpt_denoise,
)
from .dtcwt import (
    DTCWT2Result, DTCWTResult, dtcwt, dtcwt2, dtcwt2_denoise, dtcwt_denoise,
    idtcwt, idtcwt2, qshift_design, qshift_wavelets,
)
from .ewt import EWTResult, ewt1d, ewt_filter_bank, iewt1d
from .fft import (
    dft, dft_matrix, fft, fft_interleaved, idft, ifft, ifft_interleaved,
)
from .fwt import (
    analysis_step, decompose, fwt, fwt2, fwt3, ifwt, ifwt2, ifwt3, recompose,
    synthesis_step,
)
from .lifting import (
    cdf53, cdf97, icdf53, icdf97, lifting_fwt, lifting_ifwt,
)
from .modwt import (
    MAX_DECOMPOSITION_LEVEL, circular_convolve, circular_convolve_adjoint,
    imodwt, modwt, modwt_base_filters, modwt_mra,
)
from .modwpt import (
    imodwpt, imodwpt2, imodwpt3, modwpt, modwpt2, modwpt2_basis_reconstruct,
    modwpt2_best_basis, modwpt2_tree, modwpt3, modwpt_basis_reconstruct,
    modwpt_best_basis, modwpt_mra, modwpt_node_path, modwpt_tree,
)
from .modwt2d import imodwt2, imodwt3, modwt2, modwt2_mra, modwt3, modwt3_mra
from .pywt_compat import (
    coeffs_to_flat, dwt, dwt2, dwt3, flat_to_coeffs, idwt, idwt2, idwt3,
    wavedec, wavedec2, wavedec3, waverec, waverec2, waverec3,
)
from .ridge import RidgeResult, extract_ridges
from .scattering import ScatteringResult, scattering1d, scattering_filters
from .scattering2d import (
    Scattering2DResult, scattering2d, scattering2d_filters,
)
from .ssq import SSQResult, issq_cwt, ssq_cwt
from .wpt import (
    basis_coefficients, basis_coefficients2, basis_reconstruct,
    basis_reconstruct2, best_basis, best_basis2, iwpt, iwpt2, iwpt3,
    log_energy_cost, shannon_entropy_cost, sure_cost, threshold_cost, wpt,
    wpt2, wpt2_tree, wpt3, wpt_tree,
)

__all__ = [
    "analysis_step", "decompose", "fwt", "fwt2", "fwt3", "ifwt", "ifwt2",
    "ifwt3", "recompose", "synthesis_step",
    "modwt", "imodwt", "modwt_mra", "modwt_base_filters",
    "MAX_DECOMPOSITION_LEVEL", "circular_convolve",
    "circular_convolve_adjoint",
    "imodwpt", "modwpt", "modwpt_basis_reconstruct", "modwpt_best_basis",
    "modwpt_mra", "modwpt_node_path", "modwpt_tree",
    "modwt2", "imodwt2", "modwt2_mra", "modwpt2", "imodwpt2", "modwpt2_tree",
    "modwpt2_best_basis", "modwpt2_basis_reconstruct",
    "modwt3", "imodwt3", "modwt3_mra", "modwpt3", "imodwpt3",
    "basis_coefficients", "basis_reconstruct", "best_basis", "iwpt", "iwpt2",
    "basis_coefficients2", "basis_reconstruct2", "best_basis2", "wpt2_tree",
    "iwpt3", "wpt", "wpt2", "wpt3", "wpt_tree",
    "cwt", "cwt_direct", "icwt", "CWTResult", "generate_log_scales",
    "generate_linear_scales", "pad_signal",
    "banded_supported", "band_plan", "cwt_banded_coefficients",
    "cwt_banded_wd",
    "log_energy_cost", "shannon_entropy_cost", "sure_cost", "threshold_cost",
    "soft_threshold", "hard_threshold", "mad_sigma", "universal_threshold",
    "sure_threshold", "bayes_threshold", "modwt_denoise",
    "modwt_denoise_inplace", "modwt2_denoise", "modwt3_denoise",
    "wpt_denoise", "wpt2_denoise",
    "dwt", "idwt", "dwt2", "idwt2", "dwt3", "idwt3", "wavedec", "waverec",
    "wavedec2", "waverec2", "wavedec3", "waverec3", "coeffs_to_flat",
    "flat_to_coeffs",
    "cdf53", "icdf53", "cdf97", "icdf97", "lifting_fwt", "lifting_ifwt",
    "compress_fixed", "compress_magnitude", "compress_peaks_average",
    "compression_rate",
    "aed_forward", "aed_inverse", "swt_forward", "swt_inverse",
    "qshift_design", "qshift_wavelets", "DTCWTResult", "DTCWT2Result",
    "dtcwt", "idtcwt", "dtcwt2", "idtcwt2", "dtcwt_denoise",
    "dtcwt2_denoise",
    "fft", "ifft", "fft_interleaved", "ifft_interleaved", "dft_matrix",
    "dft", "idft",
    "hilbert", "envelope", "instantaneous_frequency", "WTCResult",
    "wavelet_coherence",
    "cwt2", "icwt2", "CWT2Result", "ssq_cwt", "issq_cwt", "SSQResult",
    "extract_ridges", "RidgeResult", "scattering1d", "scattering_filters",
    "ScatteringResult", "scattering2d", "scattering2d_filters",
    "Scattering2DResult", "ewt1d", "iewt1d", "ewt_filter_bank", "EWTResult",
]
