"""Empirical Wavelet Transform — data-adaptive tight-frame band splitting.

Counterpart of ``jwave_pro_tpu/ops/ewt.py``; same semantics and names.
The EWT (Gilles 2013, IEEE TSP 61(16)) builds a Meyer-type filter bank
whose band edges adapt to the signal: detect the K strongest spectral
peaks, place boundaries between them, and construct one empirical scaling
function + K−1 empirical wavelets with smooth Meyer transitions.  The
reference's spectral tier stops at the fixed-grid CWT
(``ContinuousWaveletTransform.java:183-229``, whose one-FFT-many-
multipliers pattern this reuses).

* Peak detection takes the K largest local maxima of the half spectrum
  (every other bin −∞) by a stable descending sort, so ties go to the
  lower bin as ``lax.top_k``'s do (``torch.topk`` promises no order among
  ties).
* The filter bank is built from the boundaries with the Meyer transition
  polynomial ν(x) = x⁴(35−84x+70x²−20x³), in float64 whatever their
  dtype (the JAX package's float32 bank errs by up to ~2e-4 in the
  transition tails), and is differentiable in them;
  sin²+cos² complementarity at every edge makes it a tight frame
  (Σ_k f_k(ω)² = 1), so the inverse is the plain adjoint.
* The transform is one rfft + a (K, F) batched multiply + one batched
  irfft; each signal in a batch gets its own bank.
"""
from __future__ import annotations

import math
import typing

import numpy as np
import torch

from ..utils.device import as_input

__all__ = ["EWTResult", "ewt1d", "iewt1d", "ewt_filter_bank"]


class EWTResult(typing.NamedTuple):
    """Empirical wavelet decomposition; leading dims follow the input.

    ``components``: (..., K, N) real — band-limited modes; the tight-frame
    adjoint (:func:`iewt1d` / :meth:`reconstruct`) recovers x exactly.
    ``filters``: (..., K, N//2+1) real — the adaptive tight-frame bank
    (row 0 is the empirical scaling function, rows 1..K−1 the wavelets).
    ``boundaries``: (..., K−1) — band edges in rad/sample ∈ (0, π).
    ``peaks``: (..., K) — detected spectral peak positions in rad/sample.
    """

    components: torch.Tensor
    filters: torch.Tensor
    boundaries: torch.Tensor
    peaks: torch.Tensor

    def reconstruct(self) -> torch.Tensor:
        """Invert (tight frame ⇒ exact): see :func:`iewt1d`."""
        return iewt1d(self.components, self.filters)


def _nu(x):
    """Meyer transition polynomial on [0, 1] (wavelets/continuous.py)."""
    x = torch.clamp(x, 0.0, 1.0)
    return x ** 4 * (35.0 + x * (-84.0 + x * (70.0 - 20.0 * x)))


def _rise(omega, b, gamma):
    """sin(π/2·ν(·)) roll-ON across [b(1−γ), b(1+γ)] — 0 below, 1 above."""
    return torch.sin(0.5 * math.pi
                     * _nu((omega - (1.0 - gamma) * b)
                           / torch.clamp_min(2.0 * gamma * b, 1e-12)))


def _as_float(values, like: torch.Tensor | None = None) -> torch.Tensor:
    """Boundaries (or γ) as a floating tensor: a tensor keeps its device
    and floating dtype; host values go to ``like``'s device (the card
    without one), Python floats as float64."""
    if isinstance(values, torch.Tensor):
        t = values
    else:
        arr = np.asarray(values)
        if not np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float64)
        t = (torch.as_tensor(arr, device=like.device) if like is not None
             else as_input(arr))
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


def ewt_filter_bank(boundaries, n: int, gamma=None) -> torch.Tensor:
    """Meyer-type tight-frame bank from band edges: (..., K−1) → (..., K, F).

    ``boundaries`` are rad/sample edges in (0, π), ascending along the last
    axis.  ``gamma`` is the half-width ratio of each transition; ``None``
    picks the largest tight-frame-valid value 0.9·min_k((b_{k+1}−b_k)/
    (b_{k+1}+b_k)) per batch element (Gilles' Prop. 1 bound).  Rows satisfy
    Σ_k f_k(ω)² = 1 for every ω, hence analysis followed by the adjoint
    reconstructs exactly.  The bank is computed in float64 and returned
    in the boundaries' dtype.
    """
    b_in = _as_float(boundaries)
    if b_in.shape[-1] < 1:
        raise ValueError("need at least one boundary (two bands)")
    # float64 throughout: sqrt(1 − rise²) near rise = 1 loses up to ~2e-4
    # in float32 (the JAX package computes in the boundaries' dtype)
    b = b_in.double()
    ext = torch.cat([b, torch.full(b.shape[:-1] + (1,), math.pi,
                                   dtype=b.dtype, device=b.device)], dim=-1)
    if gamma is None:
        lo = torch.cat([torch.zeros(b.shape[:-1] + (1,), dtype=b.dtype,
                                    device=b.device), b], dim=-1)
        gamma = 0.9 * torch.amin((ext - lo) / (ext + lo), dim=-1)
    else:
        gamma = _as_float(gamma, b).double()
    gamma = gamma[..., None, None]                       # (..., 1, 1)
    omega = torch.as_tensor(2.0 * math.pi * np.arange(n // 2 + 1) / n,
                            device=b.device).to(b.dtype)
    bb = ext[..., :, None]                               # (..., K, F) edges
    rise = _rise(omega, bb, gamma)
    # band k = roll-on at edge k−1 × roll-off (complement) at edge k;
    # the scaling function has no lower edge, the last wavelet's upper
    # edge is π where the bank ends flat
    on = torch.cat([torch.ones_like(rise[..., :1, :]), rise],
                   dim=-2)[..., :-1, :]
    off = torch.sqrt(torch.clamp(1.0 - rise * rise, 0.0, 1.0))
    off = torch.cat([off[..., :-1, :], torch.ones_like(rise[..., :1, :])],
                    dim=-2)
    return (on * off).to(b_in.dtype)


def _detect_boundaries(x: torch.Tensor, k: int):
    """Top-K local spectral maxima → midpoints between consecutive peaks.

    The 'localmax' rule of Gilles' toolbox: the half spectrum's interior
    local maxima are kept (every other bin −∞), the K largest taken by a
    stable descending sort (ties to the lower bin), their sorted positions
    ω̂ give boundaries at the midpoints (ω̂_i + ω̂_{i+1})/2.  Returns
    (peaks (..., K), boundaries (..., K−1)) in rad/sample.
    """
    n = x.shape[-1]
    mag = torch.abs(torch.fft.rfft(x))
    interior = mag[..., 1:-1]
    is_max = (interior > mag[..., :-2]) & (interior >= mag[..., 2:])
    cand = torch.where(is_max, interior, -torch.inf)
    idx = torch.sort(cand, dim=-1, descending=True, stable=True)[1][..., :k]
    idx = torch.sort(idx, dim=-1)[0] + 1                 # spectrum bins
    peaks = idx.to(mag.dtype) * (2.0 * math.pi / n)
    mids = 0.5 * (peaks[..., :-1] + peaks[..., 1:])
    return peaks, mids


def ewt1d(x: torch.Tensor, n_modes: int, boundaries=None) -> EWTResult:
    """Empirical Wavelet Transform of real ``x`` (..., N) into ``n_modes``
    adaptive bands.

    ``boundaries``: optional explicit band edges (rad/sample, ascending,
    shape (..., n_modes−1)) — skips detection.  Batches over leading dims
    (each batch element gets its own adaptive bank) and differentiates.
    Reconstruction is the tight-frame adjoint: ``iewt1d(components,
    filters)`` recovers x.  Integer input is transformed in float32;
    bfloat16 and float16 input in float32 too (the JAX package raises for
    bfloat16: its rfft takes float32 or float64 only).
    """
    x = as_input(x)
    if x.is_complex():
        raise ValueError("ewt1d expects a real signal")
    if not x.is_floating_point() or x.dtype in (torch.bfloat16,
                                                torch.float16):
        x = x.to(torch.float32)
    n = x.shape[-1]
    if n_modes < 2:
        raise ValueError("need at least 2 modes")
    if n_modes * 4 > n:
        raise ValueError(f"n_modes={n_modes} too large for N={n}")
    if boundaries is None:
        peaks, bounds = _detect_boundaries(x, n_modes)
    else:
        bounds = _as_float(boundaries, x).to(device=x.device,
                                             dtype=x.dtype)
        if bounds.shape[-1] != n_modes - 1:
            raise ValueError(
                f"expected {n_modes - 1} boundaries, got {bounds.shape[-1]}")
        peaks = torch.zeros(bounds.shape[:-1] + (n_modes,),
                            dtype=bounds.dtype, device=bounds.device)
    filters = ewt_filter_bank(bounds, n).to(x.dtype)
    xf = torch.fft.rfft(x)[..., None, :]
    comps = torch.fft.irfft(xf * filters, n=n)
    return EWTResult(components=comps, filters=filters,
                     boundaries=bounds, peaks=peaks)


def iewt1d(components: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Inverse EWT: ``(..., K, N), (..., K, F) → (..., N)``.

    The tight-frame adjoint — rfft each component, multiply by the SAME
    (real) filters, sum bands, irfft: exact because Σ_k f_k(ω)² = 1.
    """
    components = as_input(components)
    n = components.shape[-1]
    cf = torch.fft.rfft(components)
    return torch.fft.irfft(torch.sum(cf * filters, dim=-2), n=n)
