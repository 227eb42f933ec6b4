from .cwt import (
    CWTResult, cwt, generate_linear_scales, generate_log_scales, pad_signal,
)
from .denoise import (
    bayes_threshold, hard_threshold, mad_sigma, modwt2_denoise,
    modwt3_denoise, modwt_denoise, modwt_denoise_inplace, soft_threshold,
    sure_threshold, universal_threshold,
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
from .wpt import (
    log_energy_cost, shannon_entropy_cost, sure_cost, threshold_cost,
)

__all__ = [
    "modwt", "imodwt", "modwt_mra", "modwt_base_filters",
    "MAX_DECOMPOSITION_LEVEL", "circular_convolve",
    "circular_convolve_adjoint",
    "imodwpt", "modwpt", "modwpt_basis_reconstruct", "modwpt_best_basis",
    "modwpt_mra", "modwpt_node_path", "modwpt_tree",
    "modwt2", "imodwt2", "modwt2_mra", "modwpt2", "imodwpt2", "modwpt2_tree",
    "modwpt2_best_basis", "modwpt2_basis_reconstruct",
    "modwt3", "imodwt3", "modwt3_mra", "modwpt3", "imodwpt3",
    "cwt", "CWTResult", "generate_log_scales", "generate_linear_scales",
    "pad_signal",
    "log_energy_cost", "shannon_entropy_cost", "sure_cost", "threshold_cost",
    "soft_threshold", "hard_threshold", "mad_sigma", "universal_threshold",
    "sure_threshold", "bayes_threshold", "modwt_denoise",
    "modwt_denoise_inplace", "modwt2_denoise", "modwt3_denoise",
]
