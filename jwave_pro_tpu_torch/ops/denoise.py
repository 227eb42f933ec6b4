"""Wavelet denoising: soft/hard thresholding + the 1D MODWT denoise pipeline.

Counterpart of the 1D half of ``jwave_pro_tpu/ops/denoise.py``.  The
reference demonstrates MODWT soft-threshold denoising in
``jwave/examples/MODWTExample.java:125-172`` (universal threshold
σ·√(2·ln N) with σ estimated from level-1 detail coefficients via
MAD/0.6745, soft-shrink details, keep approximation, inverse).
"""
from __future__ import annotations

import math

import torch

from ..wavelets.base import DiscreteWavelet
from .modwt import imodwt, modwt

__all__ = [
    "soft_threshold", "hard_threshold", "universal_threshold",
    "sure_threshold", "bayes_threshold",
    "mad_sigma", "modwt_denoise", "modwt_denoise_inplace",
]


def soft_threshold(c: torch.Tensor, t) -> torch.Tensor:
    """sign(c)·max(|c|−t, 0)."""
    c = torch.as_tensor(c)
    return torch.sign(c) * torch.clamp_min(torch.abs(c) - t, 0.0)


def hard_threshold(c: torch.Tensor, t) -> torch.Tensor:
    """c·1[|c|>t]."""
    c = torch.as_tensor(c)
    return torch.where(torch.abs(c) > t, c, 0.0).to(c.dtype)


def _median(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Median with the midpoint rule for an even count, as ``jnp.median``
    (``torch.median`` returns the lower middle value instead)."""
    n = a.shape[dim]
    s = torch.sort(a, dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    return (lo + hi) * 0.5


def mad_sigma(d: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Robust noise estimate σ = median(|d|)/0.6745."""
    return _median(torch.abs(torch.as_tensor(d)), dim) / 0.6745


def universal_threshold(d: torch.Tensor, n: int | None = None,
                        dim: int = -1) -> torch.Tensor:
    """Donoho–Johnstone universal threshold σ·√(2·ln N)."""
    d = torch.as_tensor(d)
    if n is None:
        n = d.shape[dim]
    return mad_sigma(d, dim=dim) * math.sqrt(2.0 * math.log(n))


def _scale_like(sigma, d: torch.Tensor) -> torch.Tensor:
    """σ as a tensor on ``d``'s device; a Python number takes ``d``'s dtype
    (a weakly typed scalar, as in JAX)."""
    if isinstance(sigma, torch.Tensor):
        return sigma.to(d.device)
    return torch.as_tensor(sigma, dtype=d.dtype, device=d.device)


def sure_threshold(d: torch.Tensor, sigma=None, dim: int = -1) -> torch.Tensor:
    """SURE-optimal soft threshold (SureShrink, Donoho–Johnstone 1995).

    Minimizes Stein's unbiased risk estimate
    ``SURE(t) = N − 2·#{|d|≤t} + Σ min(|d|, t)²`` over candidate thresholds
    at the sorted ``|d|/σ`` values, with the sparse-case safeguard: when the
    coefficients' energy is below the ``log₂(N)^{3/2}/√N`` sparsity bound,
    the universal threshold is used instead (the "hybrid" scheme).  The
    candidates are evaluated with one sort and a cumulative sum; ties in the
    risk take the first index, as ``jnp.argmin`` does.  Returns the
    threshold on the original (unnormalized) coefficient scale.
    """
    d = torch.as_tensor(d)
    if sigma is None:
        sigma = mad_sigma(d, dim=dim)
    sigma = _scale_like(sigma, d)
    n = d.shape[dim]
    y = torch.movedim(d, dim, -1) / sigma.unsqueeze(-1)
    a = torch.sort(torch.abs(y), dim=-1).values      # candidates t = a[k]
    a2 = a * a
    csum = torch.cumsum(a2, dim=-1)
    k = torch.arange(1, n + 1, dtype=a.dtype, device=a.device)
    # risk at t=a[k-1]: N − 2k + (cum energy below t) + (n−k)·t²
    risk = (n - 2.0 * k) + csum + (n - k) * a2
    t_sure = torch.gather(a, -1, torch.argmin(risk, dim=-1, keepdim=True)
                          )[..., 0]
    # hybrid safeguard: sparse signals → universal threshold
    t_univ = math.sqrt(2.0 * math.log(n))
    energy = (csum[..., -1] - n) / n
    bound = (math.log2(n) ** 1.5) / math.sqrt(n)
    t = torch.where(energy <= bound, t_univ,
                    torch.clamp_max(t_sure, t_univ))
    return t * sigma


def bayes_threshold(d: torch.Tensor, sigma, dim: int = -1) -> torch.Tensor:
    """BayesShrink threshold σ²/σ̂ₓ (Chang–Yu–Vetterli 2000).

    ``σ`` is the noise scale (estimate it from the finest detail level via
    :func:`mad_sigma`); the signal scale is ``σ̂ₓ = √max(mean(d²) − σ², 0)``
    per band.  When the band is all noise (σ̂ₓ = 0) the threshold degenerates
    to max|d| (kill the band).
    """
    d = torch.as_tensor(d)
    sigma = _scale_like(sigma, d)
    var_y = torch.mean(d * d, dim=dim)
    sig_x = torch.sqrt(torch.clamp_min(var_y - sigma ** 2, 0.0))
    dmax = torch.amax(torch.abs(d), dim=dim)
    return torch.where(sig_x > 0.0,
                       sigma ** 2 / torch.where(sig_x > 0, sig_x, 1.0), dmax)


def _rule_threshold(kind: str, w1: torch.Tensor, details: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Threshold of rule ``kind`` with σ from the level-1 details ``w1``,
    applied per band of ``details`` (the pipeline path) or of ``w1``."""
    if kind == "universal":
        return universal_threshold(w1, n)
    if kind == "sure":
        return sure_threshold(details, mad_sigma(w1))
    if kind == "bayes":
        return bayes_threshold(details, mad_sigma(w1))
    raise ValueError(f"unknown threshold rule {kind!r}")


def modwt_denoise(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                  mode: str = "soft", method: str = "auto",
                  threshold=None) -> torch.Tensor:
    """Denoise via MODWT: shrink detail rows, keep approximation, invert.

    Matches the pipeline of ``MODWTExample.java:125-172``.  ``threshold``
    defaults to the universal threshold estimated from the level-1 details;
    the strings ``'universal'``, ``'sure'`` and ``'bayes'`` select the
    corresponding estimator applied PER DETAIL LEVEL (σ always from the
    level-1 MAD); a number or tensor is used as-is (broadcast against the
    detail rows).

    ``method='fused'`` runs forward → shrink → inverse as ONE CUDA kernel
    (``kernels/denoise_cuda.py``; its plain version on the CPU): the
    coefficients never reach device memory.  The default threshold then
    costs one extra single-level pass, since the universal threshold's
    median is a global statistic.  It takes one threshold per signal and
    raises for shapes the kernel does not support.
    """
    x = torch.as_tensor(x)
    if method == "fused":
        from ..kernels.denoise_cuda import modwt_denoise_fused

        squeeze = x.ndim == 1
        xf = x[None, :] if squeeze else x
        if xf.ndim != 2:
            raise ValueError("method='fused' supports (N,) or (B, N) input")
        if threshold is None or isinstance(threshold, str):
            w1 = modwt(xf, wavelet, 1, "direct")[0]
            threshold = _rule_threshold(threshold or "universal", w1, w1,
                                        xf.shape[-1])
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=xf.device).broadcast_to(xf.shape[:1])
        out = modwt_denoise_fused(xf, thr.contiguous(), wavelet, level, mode)
        return out[0] if squeeze else out
    c = modwt(x, wavelet, level, method)
    if threshold is None or isinstance(threshold, str):
        threshold = _rule_threshold(threshold or "universal", c[0],
                                    c[:level], x.shape[-1])[..., None]
    shrink = soft_threshold if mode == "soft" else hard_threshold
    details = shrink(c[:level], threshold)
    return imodwt(torch.cat([details, c[level:]], dim=0), wavelet, method)


def modwt_denoise_inplace(x: torch.Tensor, wavelet: DiscreteWavelet,
                          level: int, mode: str = "soft",
                          method: str = "auto") -> torch.Tensor:
    """:func:`modwt_denoise` with the result written into ``x``'s storage.

    The counterpart of the JAX package's buffer donation
    (``donate_argnums=0``): the caller's signal buffer receives the
    reconstruction, so the caller holds no second signal-sized result.
    Returns ``x``.  ``x`` must be a floating-point tensor.
    """
    if not x.is_floating_point():
        raise TypeError(f"in-place denoise needs a floating tensor, got "
                        f"{x.dtype}")
    return x.copy_(modwt_denoise(x, wavelet, level, mode=mode, method=method))
