"""Wavelet denoising: soft/hard thresholding + the MODWT denoise pipelines.

Counterpart of ``jwave_pro_tpu/ops/denoise.py``: the 1D, 2D and 3D MODWT
pipelines and the best-basis packet denoisers.  The
reference demonstrates MODWT soft-threshold denoising in
``jwave/examples/MODWTExample.java:125-172`` (universal threshold
σ·√(2·ln N) with σ estimated from level-1 detail coefficients via
MAD/0.6745, soft-shrink details, keep approximation, inverse).
"""
from __future__ import annotations

import math

import torch

from ..utils.device import as_input, as_signal
from ..utils.profiling import spanned
from ..wavelets.base import DiscreteWavelet
from .modwt import imodwt, modwt
from .wpt import (basis_coefficients, basis_coefficients2, basis_reconstruct,
                  basis_reconstruct2, best_basis, best_basis2)

__all__ = [
    "soft_threshold", "hard_threshold", "universal_threshold",
    "sure_threshold", "bayes_threshold",
    "mad_sigma", "modwt_denoise", "modwt_denoise_inplace", "modwt2_denoise",
    "modwt3_denoise", "wpt_denoise", "wpt2_denoise",
]


def _threshold_like(t, c: torch.Tensor):
    """``t`` against the coefficients ``c``: a Python number stays a number
    (weakly typed, as in JAX), a tensor moves to ``c``'s device, anything
    else (a NumPy array, a list) becomes a tensor on ``c``'s device in
    ``c``'s dtype."""
    if isinstance(t, (int, float)):
        return t
    if isinstance(t, torch.Tensor):
        return t.to(c.device)
    return torch.as_tensor(t, dtype=c.dtype, device=c.device)


def soft_threshold(c: torch.Tensor, t) -> torch.Tensor:
    """sign(c)·max(|c|−t, 0)."""
    c = as_input(c)
    t = _threshold_like(t, c)
    return torch.sign(c) * torch.clamp_min(torch.abs(c) - t, 0.0)


def hard_threshold(c: torch.Tensor, t) -> torch.Tensor:
    """c·1[|c|>t]."""
    c = as_input(c)
    t = _threshold_like(t, c)
    return torch.where(torch.abs(c) > t, c, 0.0).to(c.dtype)


def _median(a: torch.Tensor, axis: int | tuple[int, ...] | None,
            absolute: bool = False) -> torch.Tensor:
    """Median with the midpoint rule for an even count, as ``jnp.median``
    (``torch.median`` returns the lower middle value instead): NaN wherever
    the reduced axes hold a NaN, over every element for ``axis=None``, over
    all of them for a tuple (moved to the end and flattened); of ``|a|``
    for ``absolute``.

    A float32 operand on the card or the CPU takes the exact radix select
    (``kernels/median_cuda.py``: the kernel on the card, its plain version
    on the CPU), bitwise the sort's result (order keys put −0 below +0, where
    the sort may return either); other dtypes, and an operand that needs
    its gradient, take the sort."""
    if axis is None:
        a, axis = a.reshape(-1), 0
    elif isinstance(axis, tuple):
        k = len(axis)
        a = torch.movedim(a, axis, tuple(range(-k, 0)))
        a, axis = a.reshape(a.shape[:a.ndim - k] + (-1,)), -1
    if (a.dtype == torch.float32 and a.numel()
            and a.device.type in ("cuda", "cpu")
            and not (a.requires_grad and torch.is_grad_enabled())):
        from ..kernels.median_cuda import median_rows

        return median_rows(torch.movedim(a, axis, -1), absolute)
    return _sort_median(torch.abs(a) if absolute else a, axis)


def _sort_median(a: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`_median` by a sort of the whole axis (``torch.sort`` puts NaN
    last), reading its two middle values."""
    n = a.shape[axis]
    s = torch.sort(a, dim=axis).values
    lo = s.narrow(axis, (n - 1) // 2, 1).squeeze(axis)
    hi = s.narrow(axis, n // 2, 1).squeeze(axis)
    mid = (lo + hi) * 0.5
    return torch.where(torch.isnan(a).any(axis), torch.nan, mid)


def mad_sigma(d: torch.Tensor, axis: int | None = -1) -> torch.Tensor:
    """Robust noise estimate σ = median(|d|)/0.6745."""
    return _median(as_input(d), axis, absolute=True) / 0.6745


def universal_threshold(d: torch.Tensor, n: int | None = None,
                        axis: int = -1) -> torch.Tensor:
    """Donoho–Johnstone universal threshold σ·√(2·ln N)."""
    d = as_input(d)
    if n is None:
        n = d.shape[axis]
    return mad_sigma(d, axis=axis) * math.sqrt(2.0 * math.log(n))


def _scale_like(sigma, d: torch.Tensor) -> torch.Tensor:
    """σ as a tensor on ``d``'s device; a Python number takes ``d``'s dtype
    (a weakly typed scalar, as in JAX)."""
    if isinstance(sigma, torch.Tensor):
        return sigma.to(d.device)
    return torch.as_tensor(sigma, dtype=d.dtype, device=d.device)


def sure_threshold(d: torch.Tensor, sigma=None, axis: int = -1
                   ) -> torch.Tensor:
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
    d = as_input(d)
    if sigma is None:
        sigma = mad_sigma(d, axis=axis)
    sigma = _scale_like(sigma, d)
    n = d.shape[axis]
    y = torch.movedim(d, axis, -1) / sigma.unsqueeze(-1)
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


def bayes_threshold(d: torch.Tensor, sigma, axis: int = -1) -> torch.Tensor:
    """BayesShrink threshold σ²/σ̂ₓ (Chang–Yu–Vetterli 2000).

    ``σ`` is the noise scale (estimate it from the finest detail level via
    :func:`mad_sigma`); the signal scale is ``σ̂ₓ = √max(mean(d²) − σ², 0)``
    per band.  When the band is all noise (σ̂ₓ = 0) the threshold degenerates
    to max|d| (kill the band).
    """
    d = as_input(d)
    sigma = _scale_like(sigma, d)
    var_y = torch.mean(d * d, dim=axis)
    sig_x = torch.sqrt(torch.clamp_min(var_y - sigma ** 2, 0.0))
    dmax = torch.amax(torch.abs(d), dim=axis)
    return torch.where(sig_x > 0.0,
                       sigma ** 2 / torch.where(sig_x > 0, sig_x, 1.0), dmax)


@spanned("jwave.denoise.threshold")
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


@spanned("jwave.modwt_denoise")
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

    Under ``'auto'`` and ``'pallas'`` on the card, the shrink runs inside
    the inverse kernel, which shrinks each detail row as it loads it
    (:func:`_shrink_operands` says where: float32/bfloat16 coefficients, a
    number or one threshold a detail row of each signal, no gradient);
    the result is bitwise that of the shrink and :func:`imodwt` in turn,
    which every other call runs.

    ``method='fused'`` runs forward → shrink → inverse as ONE CUDA kernel
    (``kernels/denoise_cuda.py``; its plain version on the CPU): the
    coefficients never reach device memory.  The default threshold then
    costs one extra single-level pass, since the universal threshold's
    median is a global statistic.  It takes one threshold per signal and
    raises for shapes the kernel does not support.
    """
    x = as_input(x)
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
    if method in ("auto", "pallas"):
        hard = int(mode != "soft")
        operands = _shrink_operands(c, threshold, wavelet, hard)
        if operands is not None:
            from ..kernels.modwt_cuda import modwt_inv_shrink_cuda

            c3 = c if c.ndim == 3 else c.unsqueeze(1)
            out = modwt_inv_shrink_cuda(c3.contiguous(), *operands, wavelet,
                                        hard)
            return out.reshape(c.shape[1:])
    return imodwt(_shrunk(c, level, threshold, mode), wavelet, method)


@spanned("jwave.denoise.shrink")
def _shrunk(c: torch.Tensor, details: int, threshold, mode: str
            ) -> torch.Tensor:
    """``c`` with its first ``details`` rows (the detail rows or bands)
    shrunk by ``threshold``."""
    shrink = soft_threshold if mode == "soft" else hard_threshold
    return torch.cat([shrink(c[:details], threshold), c[details:]], dim=0)


def _shrink_operands(c: torch.Tensor, threshold, wavelet: DiscreteWavelet,
                     hard: int):
    """The threshold operands with which the shrinking inverse kernel
    (``kernels/modwt_cuda.py:modwt_inv_shrink_cuda``) computes
    ``imodwt(_shrunk(c, level, threshold, mode))`` bit for bit from the
    coefficients ``c`` (level+1, B, N) or (level+1, N), ``hard`` 1 for
    ``mode='hard'``: ``(thr, value)``, ``thr`` a (level, B) view of a
    threshold tensor (stride 0 where it broadcasts) and ``value`` unused,
    or ``thr`` None and ``value`` a number threshold as the card's torch
    takes it against a bfloat16 tensor: in float32 where it subtracts it,
    rounded to bfloat16 where it compares with it.

    None, and the plain shrink and :func:`imodwt` run, where the kernel
    would not give that answer: coefficients off the card or not
    float32/bfloat16, a shape the inverse kernel does not take, a
    gradient wanted of the coefficients or the threshold, a threshold
    tensor of another dtype (the shrink would promote), one that is not
    one value a detail row of each signal (its last axis longer than 1,
    or not broadcasting to (level, ..., 1)), a bool, or an integer past
    2⁵³ (which a double does not hold exactly)."""
    from ..kernels._launch import DTYPE_CODES
    from ..kernels.modwt_cuda import kernel_supported

    level = c.shape[0] - 1
    if not (c.is_cuda and c.dtype in DTYPE_CODES and c.ndim in (2, 3)
            and kernel_supported(c.shape[-1], level, wavelet.length, "inv")):
        return None
    return _cut_operands(c, threshold, hard, level, 1)


def _shrink2_operands(c: torch.Tensor, threshold, wavelet: DiscreteWavelet,
                      hard: int):
    """:func:`_shrink_operands` for the 2D shrinking inverse
    (``kernels/modwt2_cuda.py:modwt2_inv_shrink_cuda``), which computes
    ``imodwt2(_shrunk(c, 3·level, threshold, mode))`` bit for bit from the
    coefficients ``c`` (3·level+1, B, R, C) or (3·level+1, R, C): ``thr`` a
    (3·level, B) view of a threshold tensor that is one value a band of
    each image (a number, a per-image (B, 1, 1), the per-band rules'
    (3·level, B, 1, 1)), or a number ``value``.  None where the 2D inverse
    kernel does not take the shape, and wherever :func:`_shrink_operands`
    gives None (a threshold that varies within a band among them)."""
    from ..kernels._launch import DTYPE_CODES
    from ..kernels.modwt2_cuda import kernel2d_supported

    bands = c.shape[0] - 1
    if not (c.is_cuda and c.dtype in DTYPE_CODES and c.ndim in (3, 4)
            and kernel2d_supported(c.shape[-2], c.shape[-1], bands // 3,
                                   wavelet.length, "inv")):
        return None
    return _cut_operands(c, threshold, hard, bands, 2)


def _cut_operands(c: torch.Tensor, threshold, hard: int, details: int,
                  nd: int):
    """The shrinking inverses' threshold operands for the first ``details``
    rows of ``c`` (details, [B,] and ``nd`` sample axes): ``(thr, 0.0)``,
    ``thr`` a (details, B) view of a threshold tensor of c's dtype that is
    one value a row of each signal or image (stride 0 where it
    broadcasts), or ``(None, value)``, ``value`` a number threshold as the
    card's torch takes it (:func:`_shrink_operands`); None otherwise."""
    t = _threshold_like(threshold, c)
    if isinstance(t, bool) or (isinstance(t, int) and abs(t) > 2 ** 53):
        return None
    if isinstance(t, (int, float)):
        if _needs_grad(c):
            return None
        value = float(t)
        if hard and c.dtype == torch.bfloat16:
            value = float(torch.tensor(value, dtype=torch.float32)
                          .to(torch.bfloat16))
        return None, value
    shape = (details,) + tuple(c.shape[1:])
    if (t.dtype != c.dtype or _needs_grad(c, t) or t.ndim > len(shape)
            or any(a != 1 for a in t.shape[-nd:])
            or any(a not in (1, b) for a, b in zip(reversed(t.shape),
                                                   reversed(shape)))):
        return None
    thr = t.expand(shape[:-nd] + (1,) * nd)
    for _ in range(nd):
        thr = thr.select(-1, 0)
    return (thr if c.ndim == nd + 2 else thr.unsqueeze(1)), 0.0


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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


def _per_image(threshold, x: torch.Tensor, dtype: torch.dtype,
               nd: int = 2):
    """A threshold array for the ``nd``-D pipeline (2 or 3), in the
    coefficients' ``dtype`` (a float64 NumPy array does not promote float32
    bands): a 1-D array of length B with a (B, R, C) or (B, D, R, C) input
    is one threshold per image or volume, ``(B, 1, ...)``; any other array
    broadcasts as given against the detail bands.  A number stays a Python
    number (weakly typed, as in JAX)."""
    if isinstance(threshold, (int, float)):
        return threshold
    t = torch.as_tensor(threshold, dtype=dtype, device=x.device)
    if x.ndim == nd + 1 and t.ndim == 1 and t.shape[0] == x.shape[0]:
        return t.reshape((-1,) + (1,) * nd)
    return t


@spanned("jwave.modwt2_denoise")
def modwt2_denoise(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                   mode: str = "soft", threshold=None,
                   method: str = "auto") -> torch.Tensor:
    """Image denoising via the 2D MODWT (undecimated, shift-invariant).

    The 2D extension of :func:`modwt_denoise` (``MODWTExample.java:125-172``
    pipeline): shrink every detail band (LH/HL/HH per level), keep LL,
    invert.  σ is estimated from the finest diagonal band HH₁ (MAD/0.6745
    over its R·C samples, per image), and ``threshold`` defaults to the
    universal threshold σ·√(2·ln(R·C)); the strings ``'universal'``,
    ``'sure'`` and ``'bayes'`` select the rule applied per band.

    Accepted threshold shapes: a number (every band and image); a 1-D array
    of length B with a batched ``(B, R, C)`` input, one threshold per image
    under every method (the pipeline reshapes it to ``(B, 1, 1)``); any
    other array broadcasts as given against the ``(3L, ..., R, C)`` detail
    bands ('auto'/'direct') or must give one value per image ('fused').

    ``method``: 'auto' (the fused 2D CUDA kernels for the transforms where
    they apply; on the card the shrink runs inside the inverse kernel,
    which shrinks each detail band as it loads it, where
    :func:`_shrink2_operands` says so: float32/bfloat16 coefficients, a
    number or one threshold a band of each image, no gradient; the result
    is bitwise that of the shrink and :func:`imodwt2` in turn, which every
    other call runs), 'direct' (the plain separable path), or 'fused' —
    forward → shrink → inverse as ONE CUDA kernel
    (``kernels/modwt2_cuda.py``; its plain version on the CPU), for (R, C)
    or (B, R, C) input and per-image thresholds
    (None/'universal'/number/array); the default threshold then costs one
    extra single-level pass.  'sure' and 'bayes' are rejected under
    'fused', as in the JAX package.
    """
    from .modwt2d import imodwt2, modwt2

    x = as_input(x)
    if method == "fused":
        from ..kernels.modwt2_cuda import modwt2_denoise_fused

        xf = x[None] if x.ndim == 2 else x
        if xf.ndim != 3:
            raise ValueError("method='fused' supports (R, C) or (B, R, C)")
        if threshold is None or isinstance(threshold, str):
            if threshold not in (None, "universal"):
                raise ValueError(
                    "method='fused' supports scalar-per-image thresholds "
                    f"(None/'universal'/array), not {threshold!r}")
            threshold = universal_threshold(
                modwt2(xf, wavelet, 1, method="direct")[2].flatten(-2))
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=xf.device).ravel()
        thr = thr.broadcast_to(xf.shape[:1]).contiguous()
        out = modwt2_denoise_fused(xf, thr, wavelet, level, mode)
        return out[0] if x.ndim == 2 else out
    if method not in ("auto", "direct"):
        raise ValueError(f"unknown method {method!r}")
    c = modwt2(x, wavelet, level, method=method)   # (3L+1, ..., R, C)
    n_bands = 3 * level
    if threshold is None or isinstance(threshold, str):
        hh1 = c[2].flatten(-2)                   # finest diagonal band
        threshold = _rule_threshold(threshold or "universal", hh1,
                                    c[:n_bands].flatten(-2),
                                    hh1.shape[-1])[..., None, None]
    else:
        threshold = _per_image(threshold, x, c.dtype)
    if method == "auto":
        hard = int(mode != "soft")
        operands = _shrink2_operands(c, threshold, wavelet, hard)
        if operands is not None:
            from ..kernels.modwt2_cuda import modwt2_inv_shrink_cuda

            c4 = c if c.ndim == 4 else c.unsqueeze(1)
            out = modwt2_inv_shrink_cuda(c4.contiguous(), *operands,
                                         wavelet, hard)
            return out.reshape(c.shape[1:])
    return imodwt2(_shrunk(c, n_bands, threshold, mode), wavelet,
                   method=method)


@spanned("jwave.modwt3_denoise")
def modwt3_denoise(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                   mode: str = "soft", threshold=None) -> torch.Tensor:
    """Volume denoising via the 3D MODWT: shrink every detail octant (7 per
    level), keep LLL, invert.

    σ is estimated from the finest all-highpass octant HHH₁ (MAD/0.6745
    over its D·R·C samples, per volume), and ``threshold`` defaults to the
    universal threshold σ·√(2·ln(D·R·C)); ``'universal'``, ``'sure'`` and
    ``'bayes'`` select the rule applied per band.  A number applies to
    every band and volume; a 1-D array of length B with a batched
    ``(B, D, R, C)`` input is one threshold per volume; any other array
    broadcasts as given against the ``(7L, ..., D, R, C)`` detail bands.
    Rides the 3D CUDA kernels both ways under the transforms' ``'auto'``
    dispatch.
    """
    from .modwt2d import imodwt3, modwt3

    x = as_input(x)
    c = modwt3(x, wavelet, level)            # (7L+1, ..., D, R, C)
    n_bands = 7 * level
    if threshold is None or isinstance(threshold, str):
        hhh1 = c[6].flatten(-3)                # finest corner octant
        threshold = _rule_threshold(threshold or "universal", hhh1,
                                    c[:n_bands].flatten(-3),
                                    hhh1.shape[-1])[..., None, None, None]
    else:
        threshold = _per_image(threshold, x, c.dtype, nd=3)
    return imodwt3(_shrunk(c, n_bands, threshold, mode), wavelet)


@spanned("jwave.wpt_denoise")
def wpt_denoise(x: torch.Tensor, wavelet: DiscreteWavelet, level=None,
                cost: str = "sure", mode: str = "soft",
                threshold=None, per_sample: bool = False) -> torch.Tensor:
    """Best-basis packet denoising: adapt the basis to the signal, then
    shrink.

    Coifman–Wickerhauser best-basis selection (:func:`.wpt.best_basis`,
    default ``cost='sure'``, risk-matched to the soft shrinkage applied
    after) on the noisy signal, then threshold the mixed-level basis
    coefficients and reconstruct, keeping the pure low-pass packet (node 0
    at its leaf level) unshrunk.  ``threshold`` defaults to the universal
    threshold from the level-1 detail MAD.  One basis is selected for the
    whole batch (costs summed) unless ``per_sample=True``: every sample
    then adapts its own basis.  For strong narrowband (tonal) content
    prefer ``mode='hard'``: soft thresholding biases every kept
    coefficient by t.
    """
    x = as_signal(x)
    n = x.shape[-1]
    masks, _, tree = best_basis(x, wavelet, level, cost,
                                per_sample=per_sample)
    flat = basis_coefficients(tree, masks)
    if threshold is None:
        d1 = tree[1][..., n // 2:]            # level-1 details
        threshold = _rule_threshold("universal", d1, d1, n)[..., None]
    shrink = soft_threshold if mode == "soft" else hard_threshold
    shrunk = shrink(flat, threshold)
    # keep the low-pass packet: positions [0, n >> l) of the level l whose
    # leaf mask covers node 0 (per-sample masks keep their batch axes)
    pos = torch.arange(n, device=x.device)
    keep = torch.zeros((n,), dtype=torch.bool, device=x.device)
    for l, m in enumerate(masks):
        keep = keep | (m[..., 0:1] & (pos < (n >> l)))
    return basis_reconstruct(torch.where(keep, flat, shrunk), masks, wavelet)


def wpt2_denoise(x: torch.Tensor, wavelet: DiscreteWavelet, level=None,
                 cost: str = "sure", mode: str = "soft",
                 threshold=None, per_sample: bool = False) -> torch.Tensor:
    """2D best-basis packet denoising (the quad-tree analog of
    :func:`wpt_denoise`).

    Basis from :func:`.wpt.best_basis2`; σ estimated from the finest
    diagonal packet (node (1, 1) at level 1, the HH₁ convention of
    :func:`modwt2_denoise`); the low-pass packet (node (0, 0) at its leaf
    level) is kept unshrunk.
    """
    x = as_signal(x)
    r, c = x.shape[-2], x.shape[-1]
    masks, _, tree = best_basis2(x, wavelet, level, cost,
                                 per_sample=per_sample)
    flat = basis_coefficients2(tree, masks)
    if threshold is None:
        hh1 = tree[1][..., r // 2:, c // 2:]
        sigma = mad_sigma(hh1.reshape(hh1.shape[:-2] + (-1,)))
        threshold = (sigma * math.sqrt(2.0 * math.log(float(r * c)))
                     )[..., None, None]
    shrink = soft_threshold if mode == "soft" else hard_threshold
    shrunk = shrink(flat, threshold)
    rows = torch.arange(r, device=x.device)[:, None]
    cols = torch.arange(c, device=x.device)[None, :]
    keep = torch.zeros((r, c), dtype=torch.bool, device=x.device)
    for l, m in enumerate(masks):
        keep = keep | (m[..., 0:1, 0:1] & (rows < (r >> l))
                       & (cols < (c >> l)))
    return basis_reconstruct2(torch.where(keep, flat, shrunk), masks,
                              wavelet)
