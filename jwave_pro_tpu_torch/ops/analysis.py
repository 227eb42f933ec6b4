"""Wavelet-domain statistics on the MODWT: variance, covariance,
correlation, cross-correlation, Hurst exponent, per-scale energies and
variance change points; the analytic signal and CWT wavelet coherence.

Counterpart of ``jwave_pro_tpu/ops/analysis.py``; same semantics and
names.  The core tool is the Percival–Walden MODWT wavelet variance: the
signal's variance decomposed by scale, ``Var[x] = Σ_j ν²_j``, on the
shift-invariant MODWT (biased estimator over all N coefficients — the
circular-boundary convention of this library's transform), plus the tools
built on it.  ``hilbert``, ``envelope`` and ``instantaneous_frequency``
run on ``torch.fft``; ``wavelet_coherence`` smooths two ``cwt``
scalograms with host-built (float64) Torrence–Compo operators.

On a CUDA float32/bfloat16 tensor, ``method='auto'`` computes the biased
periodic variance with the single-pass fused kernel
(``kernels/variance_cuda.py``), which never writes the coefficients.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from ..utils.device import as_input, as_signal
from ..wavelets.base import DiscreteWavelet
from .fwt import _on
from .modwt import _check_level, modwt

__all__ = [
    "modwt_variance", "modwt_variance_ci", "VarianceCI", "modwt_covariance",
    "modwt_correlation", "modwt_cross_correlation", "modwt_hurst",
    "scale_energies", "ChangePoints", "modwt_changepoints",
    "hilbert", "envelope", "instantaneous_frequency", "WTCResult",
    "wavelet_coherence",
]


def _boundary_counts(n: int, level: int, filter_len: int):
    """(L_j − 1, M_j) per level: boundary-coefficient count and the number
    of interior coefficients for the unbiased Percival–Walden estimator.

    L_j = (2^j − 1)(L − 1) + 1 is the level-j equivalent-filter width
    (Percival & Walden eq. 169); the first L_j − 1 MODWT coefficients are
    affected by the circular wrap and are excluded ("brick wall").
    """
    out = []
    for j in range(1, level + 1):
        lj = ((1 << j) - 1) * (filter_len - 1) + 1
        out.append((lj - 1, n - lj + 1))
    return out


def _extend(x: torch.Tensor, boundary: str) -> torch.Tensor:
    if boundary == "periodic":
        return x
    if boundary == "reflect":
        # Percival–Walden §5.9 / waveslim convention: analyze the
        # reflection-extended series [x, reverse(x)] (length 2N) with the
        # circular machinery, removing the wrap discontinuity.
        return torch.cat([x, torch.flip(x, dims=(-1,))], dim=-1)
    raise ValueError(f"boundary must be 'periodic' or 'reflect', "
                     f"got {boundary!r}")


def modwt_variance(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                   method: str = "auto", estimator: str = "biased",
                   boundary: str = "periodic") -> torch.Tensor:
    """Per-scale wavelet variance ν²_j, shape ``(level, ...)``.

    ``estimator='biased'`` (default): mean over all coefficients — the
    detail rows then partition the sample variance,
    ``Σ_j ν²_j + mean(V_J²) − mean(x)² = Var[x]`` (energy preservation of
    the √2-normalized filter bank).

    ``estimator='unbiased'``: the Percival–Walden estimator — the first
    L_j − 1 boundary-affected coefficients of each level are excluded and
    the mean runs over the M_j = N − L_j + 1 interior ones (requires
    M_j > 0 at the deepest level).  ``boundary='reflect'`` additionally
    analyzes the reflection-extended series [x, reverse(x)] (length 2N),
    removing the circular-wrap discontinuity entirely — the standard
    choice for nonperiodic data such as financial series.

    On a CUDA f32/bf16 (B, N)/(N,) tensor the biased case runs the
    single-pass fused kernel (the coefficients never reach device memory,
    so the statistic costs about one read of the signal; the result is
    float32).  ``method='fused'`` forces it (the plain version on the CPU;
    raising if the dtype, shape or estimator is unsupported); any other
    explicit method uses the corresponding transform path.
    """
    if estimator not in ("biased", "unbiased"):
        raise ValueError(f"estimator must be 'biased' or 'unbiased', "
                         f"got {estimator!r}")
    x = _extend(as_input(x), boundary)
    if estimator == "biased":
        out = _try_var_fused(x, wavelet, level, method)
        if out is not None:
            return out
        c = modwt(x, wavelet, level, method)
        return torch.mean(c[:level] ** 2, dim=-1)
    if method == "fused":
        raise ValueError("the fused single-pass kernel computes the biased "
                         "estimator; use method='auto' with "
                         "estimator='unbiased'")
    n = x.shape[-1]
    counts = _boundary_counts(n, level, wavelet.length)
    if counts[-1][1] <= 0:
        raise ValueError(
            f"unbiased estimator needs N > (2^level − 1)(L − 1) interior "
            f"samples; level {level} with L={wavelet.length} leaves "
            f"M_J = {counts[-1][1]} ≤ 0 for N={n}")
    c = modwt(x, wavelet, level, method)
    rows = [torch.sum(c[j - 1, ..., nb:] ** 2, dim=-1) / m
            for j, (nb, m) in enumerate(counts, start=1)]
    return torch.stack(rows, dim=0)


class VarianceCI(typing.NamedTuple):
    """Wavelet variance with χ² confidence band, all shaped ``(level, ...)``
    except ``edf`` (``(level,)`` numpy)."""
    variance: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    edf: np.ndarray


def modwt_variance_ci(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                      confidence: float = 0.95, method: str = "auto",
                      estimator: str = "unbiased",
                      boundary: str = "periodic") -> VarianceCI:
    """Wavelet variance with the Percival–Walden χ² confidence interval.

    Uses the large-sample approximation ν̂²_j ~ ν²_j·χ²_η/η with the EDF-3
    band-limited heuristic η_j = max(M_j / 2^j, 1) (Percival & Walden
    eq. 313/314's practical fallback; M_j = interior-coefficient count for
    the unbiased estimator, N for the biased one), giving

        CI = [ η ν̂² / Q_η(1−α/2) ,  η ν̂² / Q_η(α/2) ]

    with Q_η the χ²_η quantile (host-side scipy, fixed per (N, level)).
    Batched in ``x``.

    With ``boundary='reflect'`` the variance averages over the 2N-length
    extended series, but the EDF is still based on the original N — the
    reflected half repeats the same N observations and adds no degrees of
    freedom.
    """
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    from scipy.stats import chi2

    x = as_input(x)
    var = modwt_variance(x, wavelet, level, method, estimator, boundary)
    n = x.shape[-1]
    if estimator == "unbiased":
        m = [max(mj, 1)
             for _, mj in _boundary_counts(n, level, wavelet.length)]
    else:
        m = [n] * level
    eta = np.maximum(np.asarray(m, dtype=np.float64)
                     / 2.0 ** np.arange(1, level + 1), 1.0)
    alpha = 1.0 - confidence
    qhi = chi2.ppf(1.0 - alpha / 2.0, eta)
    qlo = chi2.ppf(alpha / 2.0, eta)
    shape = (level,) + (1,) * (var.ndim - 1)

    def scale(s):
        return torch.as_tensor(s, dtype=var.dtype,
                               device=var.device).reshape(shape)

    return VarianceCI(var, var * scale(eta / qhi), var * scale(eta / qlo),
                      eta)


def _try_var_fused(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                   method: str):
    """The fused variance kernel when method, device, dtype and shape allow.

    ``method='auto'`` takes it for CUDA tensors only (the JAX package takes
    it on the TPU only); ``'fused'`` takes it on any device or raises.
    """
    if method not in ("auto", "fused"):
        return None
    from ..kernels import variance_cuda as kv
    from ..kernels._launch import DTYPE_CODES
    from ..kernels.modwt_cuda import kernel_supported

    x = torch.as_tensor(x)
    if x.ndim not in (1, 2) or x.dtype not in DTYPE_CODES:
        if method == "fused":
            raise ValueError(
                f"fused variance needs a float32/bfloat16 (N,) or (B, N) "
                f"input, got {x.dtype} with shape {tuple(x.shape)}")
        return None
    if method == "auto" and not x.is_cuda:
        return None
    if not kernel_supported(x.shape[-1], level, wavelet.length, "var"):
        if method == "fused":
            raise ValueError(
                f"fused variance unavailable for shape {tuple(x.shape)}")
        return None
    _check_level(x.shape[-1], level)
    return kv.modwt_var_rows(x, wavelet, level)[:level]


def modwt_covariance(x: torch.Tensor, y: torch.Tensor,
                     wavelet: DiscreteWavelet, level: int,
                     method: str = "auto") -> torch.Tensor:
    """Per-scale wavelet covariance mean(W^x_j · W^y_j), shape ``(level, ...)``.

    Decomposes Cov[x, y] by scale (plus the V_J cross term) — the tool
    behind lead/lag and co-movement analysis across horizons.

    When the fused variance kernel applies (see :func:`modwt_variance`),
    the covariance is computed by polarization —
    ``cov = (var(x+y) − var(x−y))/4`` — exact by linearity of the MODWT,
    two single-pass kernels instead of 2·(L+2) coefficient passes.

    Numerics note: polarization differences two nearly-equal variances, so
    in the kernel's f32 accumulation the absolute error is ~√N·ε·ν²; when
    the true per-scale correlation is far below f32 ε (|ρ| ≲ 1e-5) use
    ``method='direct'`` — the direct mean(W^x·W^y) path has no
    cancellation.
    """
    x = as_input(x)
    y = as_input(y)
    if x.shape != y.shape:
        if method == "fused":
            raise ValueError(
                f"fused covariance needs x.shape == y.shape, got "
                f"{tuple(x.shape)} vs {tuple(y.shape)}")
    else:
        out = _try_var_fused(x + y, wavelet, level, method)
        if out is not None:
            return (out - _try_var_fused(x - y, wavelet, level, method)) / 4.0
    cx = modwt(x, wavelet, level, method)
    cy = modwt(y, wavelet, level, method)
    return torch.mean(cx[:level] * cy[:level], dim=-1)


def modwt_correlation(x: torch.Tensor, y: torch.Tensor,
                      wavelet: DiscreteWavelet, level: int,
                      method: str = "auto") -> torch.Tensor:
    """Per-scale wavelet correlation ρ_j = cov_j / √(ν²_j(x)·ν²_j(y)),
    shape ``(level, ...)``.

    The scale-decomposed Pearson correlation: how strongly two series
    co-move at each horizon (ρ ∈ [−1, 1] per scale).  Built on the same
    fused single-pass kernel as :func:`modwt_variance` when it applies —
    variance(x), variance(y) and the polarization covariance cost four
    single-pass sweeps in all, no coefficients in device memory.
    """
    cov = modwt_covariance(x, y, wavelet, level, method)
    vx = modwt_variance(x, wavelet, level, method)
    vy = modwt_variance(y, wavelet, level, method)
    return cov / torch.sqrt(vx * vy)


def modwt_cross_correlation(x: torch.Tensor, y: torch.Tensor,
                            wavelet: DiscreteWavelet, level: int,
                            max_lag: int, method: str = "auto"
                            ) -> torch.Tensor:
    """Per-scale, per-lag wavelet cross-correlation, shape
    ``(level, 2·max_lag+1, ...)``.

    ``out[j-1, max_lag+τ] = mean_t(W^x_j[t] · W^y_j[t+τ]) /
    √(ν²_j(x)·ν²_j(y))`` for τ ∈ [−max_lag, max_lag] — the Percival–Walden
    lead/lag tool by horizon: the argmax over τ at scale j estimates how
    many samples x leads (τ > 0) or trails (τ < 0) y in that frequency
    band.  Lags are circular (the library's boundary convention).
    """
    if method == "fused":
        raise ValueError(
            "cross-correlation has no fused single-pass path (every lag "
            "needs the coefficient rows); use method='auto'")
    cx = modwt(x, wavelet, level, method)[:level]
    cy = modwt(y, wavelet, level, method)[:level]
    vx = torch.mean(cx ** 2, dim=-1)
    vy = torch.mean(cy ** 2, dim=-1)
    lags = range(-max_lag, max_lag + 1)
    # y[t+τ] = roll(y, −τ)[t]
    cc = torch.stack([torch.mean(cx * torch.roll(cy, -tau, dims=-1), dim=-1)
                      for tau in lags], dim=1)
    return cc / torch.sqrt(vx * vy)[:, None]


def modwt_hurst(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                min_level: int = 2, max_level: int | None = None,
                kind: str = "fgn", weighted: bool = True,
                method: str = "auto", return_fit: bool = False):
    """Wavelet-based Hurst exponent via log-scale variance regression.

    The Abry–Veitch / Percival–Walden long-memory estimator: for a process
    with spectral density S(f) ∝ |f|^{−α}, the wavelet variance scales as
    ν²_j ∝ τ_j^{α−1} with τ_j = 2^{j−1}, so the slope β of the weighted
    least-squares fit of log₂ ν̂²_j on log₂ τ_j estimates α − 1, and

        kind='fgn':  H = (β + 2) / 2   (stationary fGn-like series,
                                        e.g. financial *returns*; white
                                        noise → H = 1/2)
        kind='fbm':  H = β / 2         (nonstationary fBm-like *levels*,
                                        e.g. log-prices; random walk
                                        → H = 1/2)

    Regression uses octaves ``min_level ≤ j ≤ max_level`` (default 2..level
    — octave 1 carries most of the filter's spectral leakage) with weights
    ∝ the per-octave effective degrees of freedom N/2^j (Percival–Walden
    ch. 9 large-sample χ² approximation); ``weighted=False`` gives plain LS.

    Batched over leading axes; returns H with shape ``x.shape[:-1]`` (or
    ``(H, slope, intercept)`` with ``return_fit=True``).  The variance runs
    on the fused kernel where :func:`modwt_variance` takes it.
    """
    if max_level is None:
        max_level = level
    if not (1 <= min_level <= max_level <= level):
        raise ValueError(f"need 1 ≤ min_level ≤ max_level ≤ level, got "
                         f"{min_level}..{max_level} of {level}")
    if max_level - min_level < 1:
        raise ValueError("regression needs at least 2 octaves")
    if kind not in ("fgn", "fbm"):
        raise ValueError(f"kind must be 'fgn' or 'fbm', got {kind!r}")
    x = as_input(x)
    n = x.shape[-1]
    var = modwt_variance(x, wavelet, level, method)  # (level, ...)
    v = var[min_level - 1:max_level]                 # (J, ...)
    logv = torch.log2(torch.clamp_min(v, torch.finfo(v.dtype).tiny))
    js = np.arange(min_level, max_level + 1)
    t = np.asarray(js - 1.0)                         # log2 τ_j
    w = (n / 2.0 ** js) if weighted else np.ones_like(t)
    w = w / w.sum()
    tbar = float((w * t).sum())
    denom = float((w * (t - tbar) ** 2).sum())
    shape = (len(js),) + (1,) * (logv.ndim - 1)

    def const(a):
        return torch.as_tensor(a, dtype=logv.dtype,
                               device=logv.device).reshape(shape)

    slope = torch.sum(const((t - tbar) * w / denom) * logv, dim=0)
    h = (slope + 2.0) / 2.0 if kind == "fgn" else slope / 2.0
    if return_fit:
        intercept = torch.sum(const(w) * logv, dim=0) - slope * tbar
        return h, slope, intercept
    return h


def scale_energies(coeffs: torch.Tensor) -> torch.Tensor:
    """Total energy per row of a ``(rows, ..., N)`` coefficient array
    (the per-level energy table the reference's MODWT example prints).
    Complex rows use |c|², returning a real table."""
    coeffs = as_input(coeffs)
    if coeffs.is_complex():
        return torch.sum(torch.abs(coeffs) ** 2, dim=-1)
    return torch.sum(coeffs ** 2, dim=-1)


class ChangePoints(typing.NamedTuple):
    """Per-scale variance change-point test (see :func:`modwt_changepoints`).

    ``d``: the NCSS D-statistic per level, ``(level, ...)``;
    ``locations``: the argmax sample index (the most likely change point),
    ``(level, ...)`` int32; ``critical``: the level's asymptotic critical
    value at the requested α (shape ``(level,)``); ``significant``:
    ``d > critical`` broadcast over the batch.
    """

    d: torch.Tensor
    locations: torch.Tensor
    critical: torch.Tensor
    significant: torch.Tensor


# two-sided sup|Brownian bridge| quantiles (Kolmogorov distribution):
# P(sup|B(t)| > K_α) = α
_KOLMOGOROV_Q = {0.10: 1.2238, 0.05: 1.3581, 0.01: 1.6276}


def modwt_changepoints(x: torch.Tensor, wavelet: DiscreteWavelet,
                       level: int, method: str = "auto", alpha: float = 0.05
                       ) -> ChangePoints:
    """Per-scale variance change-point detection via the normalized
    cumulative sum of squares (NCSS) on MODWT coefficients.

    Whitcher–Byers–Guttorp–Percival ("Testing for homogeneity of variance
    in time series", 2002): under variance homogeneity the rotated
    cumulative energy ``P_k = Σ_{t≤k} W_j[t]² / Σ_t W_j[t]²`` of the
    level-j coefficients tracks the diagonal, and

        D_j = max_k |P_k − k/N|

    converges (suitably scaled) to the sup of a Brownian bridge.  A
    variance regime switch at time t₀ bends P away from the diagonal with
    its maximum deviation at t₀, so ``locations[j]`` both tests and
    localizes the break, per scale.

    Scaling uses the per-level equivalent sample size ``N_j = N/2^j``
    (same EDF argument as :func:`modwt_variance_ci`), i.e. significance is
    declared when ``D_j > K_α/√(N_j/2)`` with K_α the Kolmogorov quantile.
    Asymptotic and approximate.  Batched; the single pass is one MODWT.
    """
    if alpha not in _KOLMOGOROV_Q:
        raise ValueError(f"alpha must be one of {sorted(_KOLMOGOROV_Q)}")
    x = as_input(x)
    n = x.shape[-1]
    c = modwt(x, wavelet, level, method)[:level]     # (level, ..., N)
    e = c * c
    tot = torch.sum(e, dim=-1, keepdim=True)
    p = torch.cumsum(e, dim=-1) / torch.clamp_min(tot, torch.finfo(e.dtype).tiny)
    diag = torch.arange(1, n + 1, dtype=p.dtype, device=p.device) / n
    dev = torch.abs(p - diag)
    d = torch.amax(dev, dim=-1)
    loc = torch.argmax(dev, dim=-1).to(torch.int32)
    n_j = n / 2.0 ** np.arange(1, level + 1)
    crit = torch.as_tensor(_KOLMOGOROV_Q[alpha] / np.sqrt(n_j / 2.0),
                           dtype=d.dtype, device=d.device)
    crit_b = crit.reshape((level,) + (1,) * (d.ndim - 1))
    return ChangePoints(d, loc, crit, d > crit_b)


# -- the analytic signal and wavelet coherence ---------------------------------

def hilbert(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal x + i·H[x] of real ``x`` (..., N) — one-sided FFT.

    The spectral one-sided multiplier (2 on positive bins, 1 at DC and
    Nyquist, 0 on negative bins); batches over leading dims.  |result| is
    the amplitude envelope, its phase derivative the instantaneous
    frequency.  Integer input is read in torch's default float dtype and
    half-precision input in float32 (the FFT's dtypes): complex64, or
    complex128 for float64 input.
    """
    x = as_signal(x)
    if x.is_complex():
        raise ValueError("hilbert expects a real signal")
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    n = x.shape[-1]
    xf = torch.fft.fft(x)
    mult = torch.zeros(n, dtype=x.dtype, device=x.device)
    mult[0] = 1.0
    if n % 2 == 0:
        mult[n // 2] = 1.0
        mult[1:n // 2] = 2.0
    else:
        mult[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(xf * mult)


def envelope(x: torch.Tensor) -> torch.Tensor:
    """Amplitude envelope |x + i·H[x]| of a real signal."""
    return torch.abs(hilbert(x))


def instantaneous_frequency(x: torch.Tensor,
                            sampling_rate: float = 1.0) -> torch.Tensor:
    """Instantaneous frequency (Hz) of real ``x`` (..., N) → (..., N−1).

    Phase increments of the analytic signal via the wrap-free identity
    angle(z_{k+1}·conj(z_k)) — no unwrap pass — divided by 2πΔt.
    Meaningful for (locally) monocomponent signals.
    """
    z = hilbert(x)
    dphi = torch.angle(z[..., 1:] * torch.conj(z[..., :-1]))
    return dphi * (float(sampling_rate) / (2.0 * math.pi))


class WTCResult(typing.NamedTuple):
    """Squared wavelet coherence + cross-wavelet phase over (scale, time)."""
    coherence: torch.Tensor   # (..., S, N) real in [0, 1]
    phase: torch.Tensor       # (..., S, N) radians; x-leads-y angle
    scales: torch.Tensor      # (S,)
    times: torch.Tensor       # (N,)


@functools.lru_cache(maxsize=64)
def _coherence_smoothers(scales: tuple, n: int, sampling_rate: float,
                         octaves: float):
    """Host-precomputed (float64) smoothing operators for Torrence–Compo
    coherence.

    Time smoothing: per-scale circular convolution with the unit-sum
    Gaussian ``exp(−d²/(2a²))`` of circular distance d (a in samples),
    realized as a (S, F) multiplier on the rfft of each scale row — the
    kernel's exact DFT.  Scale smoothing: boxcar over ``octaves`` (Morlet
    decorrelation length 0.6, Torrence & Compo 1998 §6a) assuming a
    log-spaced grid; width 1 (no-op) if the grid has < 3 scales.
    """
    a = np.asarray(scales, dtype=np.float64) * sampling_rate  # in samples
    t = np.arange(n, dtype=np.float64)
    t = np.minimum(t, n - t)                     # circular distance
    ker = np.exp(-0.5 * (t[None, :] / a[:, None]) ** 2)
    ker /= ker.sum(axis=1, keepdims=True)
    tmult = np.fft.rfft(ker, axis=1)             # (S, n//2+1) complex
    s_count = len(scales)
    width = 1
    if s_count >= 3:
        dj = np.diff(np.log2(np.asarray(scales, dtype=np.float64)))
        djm = float(np.mean(dj))
        if djm > 0 and np.allclose(dj, djm, rtol=0.05):
            width = min(s_count, max(1, int(round(octaves / djm))))
    return tmult, width


def _full_time_multiplier(scales: tuple, n: int, sampling_rate: float,
                          octaves: float) -> np.ndarray:
    """The time smoother's multiplier on the full FFT grid (for complex
    rows), host float64."""
    tmult, _ = _coherence_smoothers(scales, n, sampling_rate, octaves)
    return np.fft.fft(np.fft.irfft(tmult, n=n, axis=1), axis=1)


def _half_time_multiplier(scales: tuple, n: int, sampling_rate: float,
                          octaves: float) -> np.ndarray:
    return _coherence_smoothers(scales, n, sampling_rate, octaves)[0]


def _smooth(p: torch.Tensor, key: tuple, width: int) -> torch.Tensor:
    """Apply the (time × scale) smoothing operator of the smoothers ``key``
    (scales, N, rate, octaves) to (..., S, N) rows; the multipliers are
    kept on the rows' device (``ops/fwt.py:_on``)."""
    n = p.shape[-1]
    if p.is_complex():
        mult = _on(_full_time_multiplier, key, p.dtype, p.device)
        sm = torch.fft.ifft(torch.fft.fft(p, dim=-1) * mult, dim=-1)
    else:
        cdt = torch.complex128 if p.dtype == torch.float64 \
            else torch.complex64
        mult = _on(_half_time_multiplier, key, cdt, p.device)
        sm = torch.fft.irfft(torch.fft.rfft(p, dim=-1) * mult, n=n,
                             dim=-1).to(p.dtype)
    if width > 1:
        # boxcar over the scale axis, edge-truncated (normalize by the
        # number of in-range scales at each position)
        s_count = sm.shape[-2]
        h = width // 2
        c = torch.cumsum(torch.nn.functional.pad(
            sm, (0, 0, h + 1, width - 1 - h)), dim=-2)
        sums = c[..., width:, :] - c[..., :-width, :]
        idx = np.arange(s_count)
        cnt = (np.minimum(idx + (width - 1 - h), s_count - 1)
               - np.maximum(idx - h, 0) + 1)
        sm = sums / torch.from_numpy(cnt[:, None]).to(sums.device,
                                                      sums.real.dtype)
    return sm


def wavelet_coherence(x: torch.Tensor, y: torch.Tensor, scales,
                      wavelet=None, sampling_rate: float = 1.0,
                      padding: str = "zero",
                      smoothing_octaves: float = 0.6) -> WTCResult:
    """Squared wavelet coherence R²(a, t) of two signals (Torrence–Compo).

    ``R² = |S(a⁻¹·W_x·conj(W_y))|² / (S(a⁻¹|W_x|²)·S(a⁻¹|W_y|²))`` where S
    smooths in time (per-scale Gaussian of std a) and scale (boxcar over
    ``smoothing_octaves``); without S the ratio is identically 1.  ``phase``
    is the smoothed cross-spectrum angle — the local lead/lag of x over y
    in radians at that scale.  Both transforms are ``cwt(method='auto')``.

    Smoothing is circular along time (the library-wide boundary
    convention); the scales are static (host-precomputed operators).  The
    denominator is floored at the dtype's smallest normal number, so a
    dead (all-zero) channel gives coherence 0, not NaN; the coherence is
    clipped to [0, 1].
    """
    from .cwt import cwt

    scales_t = tuple(float(s) for s in np.atleast_1d(np.asarray(
        scales.detach().cpu() if isinstance(scales, torch.Tensor)
        else scales)))
    rx = cwt(x, scales_t, wavelet, sampling_rate, padding)
    ry = cwt(y, scales_t, wavelet, sampling_rate, padding)
    wx, wy = rx.coefficients, ry.coefficients
    n = wx.shape[-1]
    key = (scales_t, n, float(sampling_rate), float(smoothing_octaves))
    width = _coherence_smoothers(*key)[1]
    rdt = wx.real.dtype
    inv_a = torch.from_numpy(1.0 / np.asarray(scales_t)[:, None]).to(
        wx.device, rdt)
    cross = wx * torch.conj(wy) if wx.is_complex() or wy.is_complex() \
        else wx * wy
    s_xy = _smooth(cross * inv_a, key, width)
    s_xx = _smooth((torch.abs(wx) ** 2) * inv_a, key, width)
    s_yy = _smooth((torch.abs(wy) ** 2) * inv_a, key, width)
    denom = torch.clamp_min(s_xx * s_yy, torch.finfo(s_xx.dtype).tiny)
    r2 = torch.clamp((torch.abs(s_xy) ** 2) / denom, 0.0, 1.0)
    phase = torch.angle(s_xy) if s_xy.is_complex() \
        else (s_xy < 0).to(r2.dtype) * math.pi
    return WTCResult(r2, phase, rx.scales, rx.time_axis)
