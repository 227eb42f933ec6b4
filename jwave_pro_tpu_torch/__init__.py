"""jwave_pro_tpu_torch — the PyTorch + CUDA port of ``jwave_pro_tpu``.

These slices hold the decimated core (the Mallat pyramid ``fwt``/``ifwt``
in 1D, 2D and 3D with its steps and ``decompose``/``recompose``, the full
wavelet packet tree ``wpt``/``iwpt`` with its best basis in 1D and 2D, the
best-basis packet denoisers ``wpt_denoise``/``wpt2_denoise`` and the
PyWavelets-style lists ``dwt``/``wavedec``/``waverec`` in 1D, 2D and 3D),
the MODWT forward → shrink → inverse path (the wavelet
registry, ``modwt``/``imodwt``/``modwt_mra``, the 1D denoise), the MODWT
statistics (variance and its confidence band, covariance, correlation,
cross-correlation, Hurst exponent, change points), the 1D shift-invariant
packet tree (``modwpt`` and its tree, MRA and best basis) with matching
pursuit, the 2D undecimated image path (``modwt2``/``imodwt2``/
``modwt2_mra``, ``modwt2_denoise`` with its single-pass ``method='fused'``,
the quad-tree packets ``modwpt2`` and their tree and best basis), the 3D
volume path (``modwt3``/``imodwt3``/``modwt3_mra``, ``modwt3_denoise``, the
oct-tree packets ``modwpt3``), the continuous wavelets and the CWT
(``cwt`` with its ``method='fused'`` multiply + inverse FFT kernel and its
``method='banded'`` pruned-band path, ``cwt_direct``, ``icwt``), the
decimated satellites (the lifting pyramids ``cdf53``/``cdf97``, the
threshold compressors, the arbitrary-length ``aed_*``/``swt_*`` wrappers,
the dual-tree complex transform ``dtcwt``/``dtcwt2`` with its denoisers),
the Fourier tools (``fft``/``ifft``, ``dft``/``idft``), the analytic
signal (``hilbert``, ``envelope``, ``instantaneous_frequency``) and
``wavelet_coherence``, the market-data preprocessing chain
(``preprocess_prices`` and its stages), the transform facades
(``build_transform``, ``Transform`` and its engines), the value stores
(``datatypes``), the console demo (``cli``), the test signals
(``utils.signals``), the serving export (``export_pipeline``/
``load_pipeline``), and the hand-written CUDA kernels behind them
(``kernels/``, built from ``csrc/`` with ``nvcc`` on first launch, each
launch a ``torch.ops.jwave`` operator that an exported graph records).
Names and signatures match the JAX package; tensors stay on the device
they arrive on, and any other input (a NumPy array, a list) goes to the
card.  Importing this package never imports JAX or ``jwave_pro_tpu``, and
the package reads no file of it.

    import jwave_pro_tpu_torch as jt
    w = jt.wavelet("Daubechies 4")
    y = jt.fwt(x, w, 5)              # (B, N), [a_5 | d_5 | ... | d_1]
    p = jt.wpt(x, jt.wavelet("Symlet 8"), 6)
    z = jt.wpt_denoise(x, jt.wavelet("Symlet 8"), 6, mode="hard")
    c = jt.modwt(x, w, 5)            # (6, B, N)
    y = jt.modwt_denoise(x, w, 5, method="fused")
    v = jt.modwt_variance(x, w, 5)   # (5, B)
    p = jt.modwpt(x, w, 3)           # (8, B, N)
    r = jt.matching_pursuit(x, w, 3, 16)
    c2 = jt.modwt2(img, w, 3)        # (10, B, R, C)
    d2 = jt.modwt2_denoise(img, w, 3, method="fused")
    c3 = jt.modwt3(vol, w, 2)        # (15, B, D, R, C)
    d3 = jt.modwt3_denoise(vol, w, 2)
    p3 = jt.modwpt3(vol, w, 2)       # (4, 4, 4, B, D, R, C)
    s = jt.generate_log_scales(1.0, 256.0, 64)
    r = jt.cwt(x, s, jt.MorletWavelet(), method="fused")   # (B, 64, N)
    d = jt.dtcwt(x, 5)               # 5 complex bands, two lowpass rows
    z = jt.cdf97(x)                  # JPEG2000 9/7 lifting, full depth
    z, sig = jt.preprocess_prices(prices)
    t = jt.build_transform("Fast Wavelet Transform", "Daubechies 4")
    den = lambda v: jt.modwt_denoise(v, w, 5, threshold=0.8)
    art = jt.export_pipeline(den, x, batch_polymorphic=True)
    y = jt.load_pipeline(art)(x)
"""
from .exceptions import (
    JWaveError, JWaveException, JWaveFailure, NotAllocated, NotFound,
    NotImplemented_, NotKnown, NotValid,
)
from . import cli, datatypes, kernels, streaming
from .ops import (
    MAX_DECOMPOSITION_LEVEL, CWT2Result, CWTResult, DTCWT2Result, DTCWTResult,
    EWTResult, RidgeResult, SSQResult, Scattering2DResult, ScatteringResult,
    WTCResult, aed_forward, aed_inverse, analysis_step, band_plan,
    banded_supported, basis_coefficients, basis_coefficients2,
    basis_reconstruct, basis_reconstruct2, bayes_threshold, best_basis,
    best_basis2, cdf53, cdf97, circular_convolve, circular_convolve_adjoint,
    coeffs_to_flat, compress_fixed, compress_magnitude, compress_peaks_average,
    compression_rate, cwt, cwt2, cwt_banded_coefficients, cwt_banded_wd,
    cwt_direct, decompose, dft, dft_matrix, dtcwt, dtcwt2, dtcwt2_denoise,
    dtcwt_denoise, dwt, dwt2, dwt3, envelope, ewt1d, ewt_filter_bank,
    extract_ridges, fft, fft_interleaved, flat_to_coeffs, fwt, fwt2, fwt3,
    generate_linear_scales, generate_log_scales, hard_threshold, hilbert,
    icdf53, icdf97, icwt, icwt2, idft, idtcwt, idtcwt2, idwt, idwt2, idwt3,
    iewt1d, ifft, ifft_interleaved, ifwt, ifwt2, ifwt3, imodwpt, imodwpt2,
    imodwpt3, imodwt, imodwt2, imodwt3, instantaneous_frequency, issq_cwt,
    iwpt, iwpt2, iwpt3, lifting_fwt, lifting_ifwt, log_energy_cost, mad_sigma,
    modwpt, modwpt2, modwpt2_basis_reconstruct, modwpt2_best_basis,
    modwpt2_tree, modwpt3, modwpt_basis_reconstruct, modwpt_best_basis,
    modwpt_mra, modwpt_node_path, modwpt_tree, modwt, modwt2, modwt2_denoise,
    modwt2_mra, modwt3, modwt3_denoise, modwt3_mra, modwt_base_filters,
    modwt_denoise, modwt_denoise_inplace, modwt_mra, pad_signal, qshift_design,
    qshift_wavelets, recompose, scattering1d, scattering2d,
    scattering2d_filters, scattering_filters, shannon_entropy_cost,
    soft_threshold, ssq_cwt, sure_threshold, swt_forward, swt_inverse,
    synthesis_step, threshold_cost, universal_threshold, wavedec, wavedec2,
    wavedec3, wavelet_coherence, waverec, waverec2, waverec3, wpt, wpt2,
    wpt2_denoise, wpt2_tree, wpt3, wpt_denoise, wpt_tree,
)
from .ops.analysis import (
    ChangePoints, VarianceCI, modwt_changepoints, modwt_correlation,
    modwt_covariance, modwt_cross_correlation, modwt_hurst, modwt_variance,
    modwt_variance_ci, scale_energies,
)
from .ops.financial import (
    cumulate_returns, ewma_volatility, fill_gaps, log_returns, median_select,
    normalize_volatility, preprocess_prices, realized_volatility,
    winsorize_outliers,
)
from .ops.mp import MPResult, matching_pursuit, mp_reconstruct
from .transforms import (
    AncientEgyptianDecomposition, ContinuousWaveletTransform,
    DiscreteFourierTransform, FastFourierTransform, FastWaveletTransform,
    MODWTTransform, ShiftingWaveletTransform, Transform,
    WaveletPacketTransform, build_transform,
)
from .utils import (
    ancient_egyptian_decomposition, is_power_of_two, max_level,
    next_power_of_two, time_chain,
)
from .utils import deploy, signals
from .utils.deploy import export_pipeline, load_pipeline
from .wavelets import (
    REGISTRY, ContinuousWavelet, ContinuousWavelet2D, DiscreteWavelet,
    DOGWavelet, MexicanHat2D, MexicanHatWavelet, MeyerWavelet, Morlet2D,
    MorletWavelet, PaulWavelet, biorthogonal, coiflet, continuous_wavelet,
    continuous_wavelet2d, daubechies, from_jax_continuous, from_jax_wavelet,
    good_wavelets, legendre, qmf_biorthogonal, qmf_orthonormal, symlet,
    wavelet, wavelet_names,
)

__all__ = [
    "JWaveException", "JWaveFailure", "JWaveError", "NotAllocated",
    "NotFound", "NotImplemented_", "NotKnown", "NotValid",
    "DiscreteWavelet", "from_jax_wavelet", "qmf_orthonormal",
    "qmf_biorthogonal", "REGISTRY", "wavelet", "wavelet_names",
    "good_wavelets", "daubechies", "symlet", "coiflet", "biorthogonal",
    "legendre",
    "modwt", "imodwt", "modwt_mra", "modwt_base_filters",
    "MAX_DECOMPOSITION_LEVEL", "circular_convolve",
    "circular_convolve_adjoint",
    "modwpt", "imodwpt", "modwpt_tree", "modwpt_mra", "modwpt_best_basis",
    "modwpt_basis_reconstruct", "modwpt_node_path",
    "modwt2", "imodwt2", "modwt2_mra", "modwt2_denoise",
    "modwpt2", "imodwpt2", "modwpt2_tree", "modwpt2_best_basis",
    "modwpt2_basis_reconstruct",
    "modwt3", "imodwt3", "modwt3_mra", "modwt3_denoise", "modwpt3",
    "imodwpt3",
    "ContinuousWavelet", "MorletWavelet", "MexicanHatWavelet", "PaulWavelet",
    "DOGWavelet", "MeyerWavelet", "continuous_wavelet",
    "cwt", "CWTResult", "generate_log_scales", "generate_linear_scales",
    "pad_signal",
    "log_energy_cost", "shannon_entropy_cost", "threshold_cost",
    "MPResult", "matching_pursuit", "mp_reconstruct",
    "modwt_variance", "modwt_variance_ci", "VarianceCI", "modwt_covariance",
    "modwt_correlation", "modwt_cross_correlation", "modwt_hurst",
    "scale_energies", "ChangePoints", "modwt_changepoints",
    "soft_threshold", "hard_threshold", "mad_sigma", "universal_threshold",
    "sure_threshold", "bayes_threshold", "modwt_denoise",
    "modwt_denoise_inplace",
    "fwt", "ifwt", "fwt2", "ifwt2", "fwt3", "ifwt3", "analysis_step",
    "synthesis_step", "decompose", "recompose",
    "wpt", "iwpt", "wpt2", "iwpt2", "wpt3", "iwpt3", "wpt_tree", "wpt2_tree",
    "best_basis", "best_basis2", "basis_coefficients", "basis_coefficients2",
    "basis_reconstruct", "basis_reconstruct2", "wpt_denoise", "wpt2_denoise",
    "dwt", "idwt", "dwt2", "idwt2", "dwt3", "idwt3", "wavedec", "waverec",
    "wavedec2", "waverec2", "wavedec3", "waverec3", "coeffs_to_flat",
    "flat_to_coeffs",
    "time_chain", "next_power_of_two", "is_power_of_two", "max_level",
    "ancient_egyptian_decomposition",
    "cdf53", "icdf53", "cdf97", "icdf97", "lifting_fwt", "lifting_ifwt",
    "compress_fixed", "compress_magnitude", "compress_peaks_average",
    "compression_rate",
    "aed_forward", "aed_inverse", "swt_forward", "swt_inverse",
    "qshift_design", "qshift_wavelets", "DTCWTResult", "DTCWT2Result",
    "dtcwt", "idtcwt", "dtcwt2", "idtcwt2", "dtcwt_denoise",
    "dtcwt2_denoise",
    "fft", "ifft", "fft_interleaved", "ifft_interleaved", "dft_matrix",
    "dft", "idft",
    "cwt_direct", "icwt", "banded_supported", "band_plan",
    "cwt_banded_coefficients", "cwt_banded_wd",
    "hilbert", "envelope", "instantaneous_frequency", "WTCResult",
    "wavelet_coherence",
    "ContinuousWavelet2D", "MexicanHat2D", "Morlet2D",
    "continuous_wavelet2d", "from_jax_continuous",
    "cwt2", "icwt2", "CWT2Result", "ssq_cwt", "issq_cwt", "SSQResult",
    "extract_ridges", "RidgeResult", "scattering1d", "scattering_filters",
    "ScatteringResult", "scattering2d", "scattering2d_filters",
    "Scattering2DResult", "ewt1d", "iewt1d", "ewt_filter_bank", "EWTResult",
    "streaming",
    "log_returns", "cumulate_returns", "fill_gaps", "median_select",
    "winsorize_outliers", "ewma_volatility", "normalize_volatility",
    "realized_volatility", "preprocess_prices",
    "Transform", "FastWaveletTransform", "WaveletPacketTransform",
    "MODWTTransform", "ContinuousWaveletTransform", "FastFourierTransform",
    "DiscreteFourierTransform", "AncientEgyptianDecomposition",
    "ShiftingWaveletTransform", "build_transform",
    "export_pipeline", "load_pipeline", "datatypes", "cli",
]
