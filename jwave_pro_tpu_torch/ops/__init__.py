from .cwt import (
    CWTResult, cwt, generate_linear_scales, generate_log_scales, pad_signal,
)
from .denoise import (
    bayes_threshold, hard_threshold, mad_sigma, modwt2_denoise,
    modwt3_denoise, modwt_denoise, modwt_denoise_inplace, soft_threshold,
    sure_threshold, universal_threshold, wpt2_denoise, wpt_denoise,
)
from .fwt import (
    analysis_step, decompose, fwt, fwt2, fwt3, ifwt, ifwt2, ifwt3, recompose,
    synthesis_step,
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
    "cwt", "CWTResult", "generate_log_scales", "generate_linear_scales",
    "pad_signal",
    "log_energy_cost", "shannon_entropy_cost", "sure_cost", "threshold_cost",
    "soft_threshold", "hard_threshold", "mad_sigma", "universal_threshold",
    "sure_threshold", "bayes_threshold", "modwt_denoise",
    "modwt_denoise_inplace", "modwt2_denoise", "modwt3_denoise",
    "wpt_denoise", "wpt2_denoise",
    "dwt", "idwt", "dwt2", "idwt2", "dwt3", "idwt3", "wavedec", "waverec",
    "wavedec2", "waverec2", "wavedec3", "waverec3", "coeffs_to_flat",
    "flat_to_coeffs",
]
