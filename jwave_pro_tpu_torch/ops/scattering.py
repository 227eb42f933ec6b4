"""1D wavelet scattering transform — batched-FFT formulation.

Counterpart of ``jwave_pro_tpu/ops/scattering.py``; same semantics and
names.  The scattering transform (Mallat 2012; Andén & Mallat 2014)
cascades complex analytic wavelet convolutions and modulus nonlinearities,
then low-pass averages every path:

    S0    =  x ⋆ φ
    S1[λ] = |x ⋆ ψ¹_λ| ⋆ φ
    S2[λ,μ] = ||x ⋆ ψ¹_λ| ⋆ ψ²_μ| ⋆ φ      (ξ_μ < ξ_λ·2^{-1/Q})

The reference has no scattering tier; this is the one-FFT-many-multiplies
pattern of ``ContinuousWaveletTransform.java:183-229`` taken two layers
deep.  Every path at a given order and rate is one batched complex
multiply and one batched (i)FFT; second-order paths are gathered with
static index tables (``index_select``).  Low-pass + ↓T subsampling is
spectral: the spectrum is folded (``Ŷ → mean over m of Ŷ[k + m·N/T]``)
and inverse-transformed at length N/T.

Filters are host float64 constants (Gabor log-spaced band-pass atoms,
Q filters/octave over J octaves, a Gaussian low-pass of time scale ~2^J,
jointly renormalized so |φ̂|² + Σ|ψ̂_k|² ≤ 1), kept on each device per
dtype.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from ..utils.device import as_input

__all__ = ["ScatteringResult", "scattering1d", "scattering_filters"]


class ScatteringResult(typing.NamedTuple):
    """Scattering coefficients; all tensors share the leading batch dims.

    ``s0``: (..., N/T) — low-passed signal (order 0).
    ``s1``: (..., L1, N/T) — first-order paths.
    ``s2``: (..., P, N/T) — second-order paths, or None if order < 2.
    ``xi1``: (L1,) numpy — first-order center frequencies (cycles/sample).
    ``pairs``: (P, 2) numpy — (first-order index, ξ² frequency) per path.
    """

    s0: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor | None
    xi1: np.ndarray
    pairs: np.ndarray

    def stack(self) -> torch.Tensor:
        """All coefficients stacked on one path axis: (..., 1+L1+P, N/T)."""
        parts = [self.s0[..., None, :], self.s1]
        if self.s2 is not None:
            parts.append(self.s2)
        return torch.cat(parts, dim=-2)


XI_MAX = 0.425  # highest center frequency, cycles/sample (below Nyquist)

_HALF_CROSS = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))  # ≈ 0.4246


def _filter_params(j: int, nq: int):
    """(ξ, σ) grids for a constant-Q bank: ``nq`` filters/octave, ``j``
    octaves."""
    k = np.arange(j * nq, dtype=np.float64)
    xi = XI_MAX * 2.0 ** (-k / nq)
    sig = xi * (1.0 - 2.0 ** (-1.0 / (2.0 * nq))) / _HALF_CROSS * 0.5
    return xi, sig


def _gabor_bank(n: int, xis: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """ψ̂ rows on the length-``n`` DFT grid (ω in cycles/sample, periodic)."""
    omega = np.arange(n, dtype=np.float64) / n
    # evaluate on ω and ω−1 so tails wrap on the periodic grid
    d0 = omega[None, :] - xis[:, None]
    d1 = omega[None, :] - 1.0 - xis[:, None]
    s2 = 2.0 * sigmas[:, None] ** 2
    g = np.exp(-d0 * d0 / s2) + np.exp(-d1 * d1 / s2)
    # Morlet-style DC correction: subtract ψ̂(0)·(zero-centered Gaussian) so
    # every atom has exactly zero mean
    osym = np.minimum(omega, 1.0 - omega)
    g -= g[:, :1] * np.exp(-osym[None, :] ** 2 / s2)
    return g


@functools.lru_cache(maxsize=64)
def scattering_filters(n: int, j: int, q: int):
    """Build the (ψ¹, ψ², φ) frequency-domain filter bank for length ``n``.

    Returns ``(psi1 (L1, n), xi1 (L1,), psi2 (L2, n), xi2 (L2,), phi (n,))``
    as float64 numpy.  First order: L1 = J·Q constant-Q atoms spanning J
    octaves below ``XI_MAX``; second order: L2 = J single-octave atoms.
    """
    if j < 1:
        raise ValueError("need at least one octave (j >= 1)")
    if q < 1:
        raise ValueError("need at least one filter per octave (q >= 1)")
    xi1, sig1 = _filter_params(j, q)
    xi2, sig2 = _filter_params(j, 1)
    psi1 = _gabor_bank(n, xi1, sig1)
    psi2 = _gabor_bank(n, xi2, sig2)
    omega = np.arange(n, dtype=np.float64) / n
    omega = np.minimum(omega, 1.0 - omega)  # symmetric low-pass
    sig_phi = 0.35 / (1 << j)
    phi = np.exp(-(omega**2) / (2.0 * sig_phi**2))
    # Littlewood–Paley renormalization: scale each bank by the largest c
    # with |φ̂|² + c·Σ|ψ̂_k|² ≤ 1 everywhere (each layer nonexpansive)
    for bank in (psi1, psi2):
        lp = (bank**2).sum(axis=0)
        mask = lp > 1e-10
        c = float(np.min(np.maximum(1.0 - phi[mask] ** 2, 0.0) / lp[mask]))
        bank *= math.sqrt(min(c, 1.0))
    return psi1, xi1, psi2, xi2, phi


@functools.lru_cache(maxsize=64)
def _pair_table(n: int, j: int, q: int):
    """Static (i1, i2) index tables for frequency-decreasing 2nd-order
    paths."""
    _, xi1, _, xi2, _ = scattering_filters(n, j, q)
    sel = xi2[None, :] < xi1[:, None] * 2.0 ** (-1.0 / q)
    i1, i2 = np.nonzero(sel)
    return i1, i2


def _lowpass_subsample(yhat: torch.Tensor, phi: torch.Tensor,
                       t: int) -> torch.Tensor:
    """ifft(fold(Ŷ·φ̂, T)) — low-pass then exact ↓T."""
    return torch.fft.ifft(_spectral_fold(yhat * phi, t)).real


def _spectral_fold(yhat: torch.Tensor, d: int) -> torch.Tensor:
    """Fold Ŷ to length N/d — the spectrum of the ↓d-decimated signal."""
    if d == 1:
        return yhat
    m = yhat.shape[-1] // d
    return yhat.reshape(*yhat.shape[:-1], d, m).mean(dim=-2)


def _subsample_filter(f_full: np.ndarray, d: int) -> np.ndarray:
    """Exact DFT-grid restriction of a length-N filter to the N/d grid.

    Decimated bin k′ < m/2 is original bin k′; bins past m/2 are the
    original negative frequencies N−m+k′ — exact for a filter supported
    inside the decimated Nyquist band.
    """
    if d == 1:
        return f_full
    n = f_full.shape[-1]
    m = n // d
    lo = m // 2 + 1
    return np.concatenate([f_full[..., :lo], f_full[..., n - (m - lo):]],
                          axis=-1)


def _decimations(top: np.ndarray, t: int, oversampling: int) -> np.ndarray:
    """Per-atom pow-2 decimation keeping Nyquist ≥ 2^oversampling× ``top``
    (the kymatio-style multiresolution rule), capped by the output stride
    T."""
    lim = 1.0 / (2.0 ** (1 + oversampling) * np.maximum(top, 1e-12))
    d = np.ones(len(top), dtype=np.int64)
    for i in range(len(top)):
        while d[i] * 2 <= lim[i] and d[i] * 2 <= t:
            d[i] *= 2
    return d


@functools.lru_cache(maxsize=256)
def _bank_on(n: int, j: int, q: int, kind: str, rows: tuple, d: int,
             dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A filter of the (n, j, q) bank on ``device``: φ̂ (``kind`` 'phi')
    or rows of ψ¹/ψ² ('psi1'/'psi2'), restricted to the ↓``d`` grid."""
    psi1, _, psi2, _, phi = scattering_filters(n, j, q)
    host = phi if kind == "phi" else (psi1 if kind == "psi1"
                                      else psi2)[list(rows)]
    return torch.from_numpy(np.ascontiguousarray(
        _subsample_filter(host, d))).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=256)
def _index_on(idx: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(idx, dtype=torch.int64, device=device)


def _index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """A static index table on ``device`` (kept there per table)."""
    return _index_on(tuple(int(i) for i in idx), device)


def scattering1d(x: torch.Tensor, j: int, q: int = 8, order: int = 2,
                 subsample: int | None = None,
                 oversampling: int = 1) -> ScatteringResult:
    """Wavelet scattering of ``x`` (..., N) over ``j`` octaves, ``q``/octave.

    ``subsample``: output stride T (defaults to 2^j, the averaging scale;
    pass 1 to keep full resolution).  N must be a multiple of T.  Batches
    over any leading dims and differentiates (the modulus subgradient at 0
    is 0).

    Multiresolution evaluation: each path runs at its own pow-2-decimated
    rate — spectra are folded as soon as a path's remaining band content
    fits the coarser Nyquist.  ``oversampling`` tightens parity with the
    full-resolution cascade (large values force every stride to 1);
    the default (1) keeps ~1e-4 (s1) / ~1e-3 (s2) relative agreement.
    Coefficients are float64 for float64 input, else float32.
    """
    x = as_input(x)
    if x.is_complex():
        # S0 = ifft(X·φ̂).real would silently drop the imaginary half
        raise ValueError("scattering1d expects a real signal")
    n = x.shape[-1]
    t = (1 << j) if subsample is None else subsample
    if t < 1 or n % t:
        raise ValueError(f"subsample stride {t} must divide N={n}")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    _, xi1, _, xi2, _ = scattering_filters(n, j, q)
    sig1 = _filter_params(j, q)[1]
    sig2 = _filter_params(j, 1)[1]
    rdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    dev = x.device

    def bank(kind, rows=(), d=1):
        return _bank_on(n, j, q, kind, rows, d, rdt, dev)

    i1, i2 = _pair_table(n, j, q)
    # First-stage rate must resolve the atom's own band AND the widest ψ²
    # later applied to its envelope; second-stage rate only the ψ² band
    need1 = xi1 + 3.0 * sig1
    top2 = xi2 + 3.0 * sig2
    if order == 2:
        for a, b in zip(i1, i2):
            need1[a] = max(need1[a], top2[b])
    d1 = _decimations(need1, t, oversampling)
    d2p = (np.maximum(d1[i1], _decimations(top2, t, oversampling)[i2])
           if i1.size else np.zeros(0, np.int64))

    xhat = torch.fft.fft(x.to(rdt))
    s0 = _lowpass_subsample(xhat, bank("phi"), t)

    s1_parts, idx_parts, u1hat_by = [], [], {}
    for d in sorted(set(d1.tolist())):
        idx = np.nonzero(d1 == d)[0]
        psi_g = bank("psi1", tuple(idx.tolist()))
        yhat = _spectral_fold(xhat[..., None, :] * psi_g, d)
        u1hat = torch.fft.fft(torch.abs(torch.fft.ifft(yhat)))  # (…, Lg, N/d)
        s1_parts.append(_lowpass_subsample(u1hat, bank("phi", (), d),
                                           t // d))
        idx_parts.append(idx)
        u1hat_by[d] = (idx, u1hat)
    s1 = (s1_parts[0] if len(s1_parts) == 1
          else torch.cat(s1_parts, dim=-2))
    perm = np.concatenate(idx_parts)
    if not np.array_equal(perm, np.arange(len(xi1))):
        s1 = s1.index_select(-2, _index(np.argsort(perm), dev))

    s2 = None
    if order == 2 and i1.size:
        s2_parts, pair_parts = [], []
        for d, (idx, u1hat) in sorted(u1hat_by.items()):
            pos = {a: k for k, a in enumerate(idx)}
            in_g = np.nonzero(d1[i1] == d)[0]
            for dd in sorted(set(d2p[in_g].tolist())):
                sel = in_g[d2p[in_g] == dd]
                loc = np.asarray([pos[a] for a in i1[sel]])
                rows = u1hat.index_select(-2, _index(loc, dev))
                psi2_g = bank("psi2", tuple(i2[sel].tolist()), d)
                u2hat = _spectral_fold(rows * psi2_g, dd // d)
                u2 = torch.abs(torch.fft.ifft(u2hat))
                s2_parts.append(_lowpass_subsample(
                    torch.fft.fft(u2), bank("phi", (), dd), t // dd))
                pair_parts.append(sel)
        s2 = (s2_parts[0] if len(s2_parts) == 1
              else torch.cat(s2_parts, dim=-2))
        po = np.concatenate(pair_parts)
        if not np.array_equal(po, np.arange(len(i1))):
            s2 = s2.index_select(-2, _index(np.argsort(po), dev))
    elif order == 2:
        s2 = torch.zeros((*x.shape[:-1], 0, n // t), dtype=s1.dtype,
                         device=dev)

    pairs = np.stack([i1, xi2[i2]], axis=-1) if i1.size else np.zeros((0, 2))
    return ScatteringResult(s0=s0, s1=s1, s2=s2, xi1=xi1, pairs=pairs)
