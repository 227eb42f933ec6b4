"""2D wavelet scattering transform — batched-FFT formulation.

Counterpart of ``jwave_pro_tpu/ops/scattering2d.py``; same semantics and
names.  The image analog of ``ops/scattering.py`` (Bruna & Mallat 2013):
cascade oriented complex Morlet convolutions and modulus nonlinearities,
then low-pass average every path:

    S0          =  x ⋆ φ_J                                  ↓ 2^J
    S1[j₁,θ₁]   = |x ⋆ ψ_{j₁,θ₁}| ⋆ φ_J                     ↓ 2^J
    S2[j₁,θ₁,j₂,θ₂] = ||x ⋆ ψ_{j₁,θ₁}| ⋆ ψ_{j₂,θ₂}| ⋆ φ_J   ↓ 2^J   (j₂ > j₁)

The reference has no scattering tier (its CWT,
``ContinuousWaveletTransform.java``, is 1D-only).  The (scale × angle)
path axis is an FFT batch axis — one batched complex multiply and one
batched ifft2 per order and rate; second-order paths are gathered with a
static index table (j₂ > j₁ only); low-pass + ↓2^J runs spectrally (fold
the spectrum along each axis, then a small inverse FFT on the (h/T, w/T)
grid).

Filters: oriented 2D Morlets ψ̂(k) = g_Σ(k − ξ e_θ) − β·g_Σ(k) (exactly
zero mean) with per-octave dilation a = 2^j, radial center ξ_j =
3π/4·2^{-j}, elliptic envelope (``slant``), L angles over [0, π); a
Gaussian low-pass φ̂_J at width 2^J.  All atoms are periodized on the DFT
grid (3×3 period wrap) and the ψ bank is Littlewood–Paley-renormalized
against |φ̂|², host float64, kept on each device per dtype.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from ..utils.device import as_input, tensor_cache
from .scattering import _index

__all__ = ["Scattering2DResult", "scattering2d", "scattering2d_filters"]


class Scattering2DResult(typing.NamedTuple):
    """2D scattering coefficients; tensors share the leading batch dims.

    ``s0``: (..., H/T, W/T) — low-passed image (order 0).
    ``s1``: (..., J·L, H/T, W/T) — first-order paths, index = j₁·L + θ₁.
    ``s2``: (..., P, H/T, W/T) — second-order paths, or None if order < 2.
    ``meta1``: (J·L, 2) numpy — (j₁, θ₁ index) per first-order path.
    ``pairs``: (P, 3) numpy — (first-order path index, j₂, θ₂ index).
    """

    s0: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor | None
    meta1: np.ndarray
    pairs: np.ndarray

    def stack(self) -> torch.Tensor:
        """All coefficients on one path axis: (..., 1+J·L+P, H/T, W/T)."""
        parts = [self.s0[..., None, :, :], self.s1]
        if self.s2 is not None:
            parts.append(self.s2)
        return torch.cat(parts, dim=-3)


XI0 = 3.0 * math.pi / 4.0   # radial center frequency at scale j = 0 (rad)
SIGMA0 = 0.8                # spatial envelope width at scale j = 0


def _periodized_gaussian2(ky, kx, cy, cx, sy, sx):
    """Σ over a 3×3 period wrap of exp(−(σ_y²(k_y−c_y)² + σ_x²(k_x−c_x)²)/2)
    on the (ky, kx) grid — (len(ky), len(kx)) float64."""
    out = np.zeros((ky.size, kx.size))
    for p in (-1.0, 0.0, 1.0):
        dy = ky[:, None] + 2.0 * math.pi * p - cy
        ey = np.exp(-0.5 * (sy * dy) ** 2)
        for q in (-1.0, 0.0, 1.0):
            dx = kx[None, :] + 2.0 * math.pi * q - cx
            out += ey * np.exp(-0.5 * (sx * dx) ** 2)
    return out


def _morlet2d_hat(h, w, j, theta, slant):
    """ψ̂_{j,θ} on the (h, w) DFT grid: rotated elliptic Gaussian at radial
    frequency ξ_j minus the DC-cancelling β·(centered copy)."""
    ky = 2.0 * math.pi * np.fft.fftfreq(h)
    kx = 2.0 * math.pi * np.fft.fftfreq(w)
    xi = XI0 / (1 << j)
    sigma = SIGMA0 * (1 << j)
    # rotate the GRID by −θ instead of the center/covariance by θ
    c, s = math.cos(theta), math.sin(theta)
    kpar = c * ky[:, None] + s * kx[None, :]
    kperp = -s * ky[:, None] + c * kx[None, :]
    # periodize: evaluate on the rotated grid, wrapping each axis of the
    # original grid
    out = np.zeros((h, w))
    ctr = np.zeros((h, w))
    for p in (-1.0, 0.0, 1.0):
        for q in (-1.0, 0.0, 1.0):
            ppar = kpar + 2.0 * math.pi * (p * c + q * s)
            pperp = kperp + 2.0 * math.pi * (-p * s + q * c)
            env = np.exp(-0.5 * ((sigma * (ppar - xi)) ** 2
                                 + (sigma / slant * pperp) ** 2))
            cen = np.exp(-0.5 * ((sigma * ppar) ** 2
                                 + (sigma / slant * pperp) ** 2))
            out += env
            ctr += cen
    # β from the periodized sums (k = 0 is grid index [0, 0]): only the
    # periodized ratio makes ψ̂(0) exactly zero
    beta = out[0, 0] / ctr[0, 0]
    return out - beta * ctr


@functools.lru_cache(maxsize=8)
def scattering2d_filters(h: int, w: int, j: int, l: int,
                         slant: float = 0.5):
    """Build the frequency-domain 2D bank for an (h, w) image.

    Returns ``(psi (J·L, h, w), phi (h, w), meta1 (J·L, 2))`` float64
    numpy; ψ row order is j-major (path index = j₁·L + θ₁), angles
    θ = π·t/L for t = 0..L−1.  The ψ bank is scaled by the largest c with
    ``|φ̂|² + c/2·Σ(|ψ̂(k)|² + |ψ̂(−k)|²) ≤ 1`` (the real-input
    Littlewood–Paley bound).
    """
    if j < 1:
        raise ValueError("need at least one octave (j >= 1)")
    if l < 1:
        raise ValueError("need at least one angle (l >= 1)")
    psi = np.stack([_morlet2d_hat(h, w, jj, math.pi * t / l, slant)
                    for jj in range(j) for t in range(l)])
    ky = 2.0 * math.pi * np.fft.fftfreq(h)
    kx = 2.0 * math.pi * np.fft.fftfreq(w)
    sig_phi = SIGMA0 * (1 << j)
    phi = _periodized_gaussian2(ky, kx, 0.0, 0.0, sig_phi, sig_phi)
    phi /= phi.max()
    # ψ̂(−k) on the DFT grid = reversed-and-rolled rows (real ψ̂ here)
    neg = np.roll(psi[:, ::-1, ::-1], (1, 1), axis=(-2, -1))
    lp = 0.5 * (psi ** 2 + neg ** 2).sum(axis=0)
    mask = lp > 1e-10
    c = float(np.min(np.maximum(1.0 - phi[mask] ** 2, 0.0) / lp[mask]))
    psi *= math.sqrt(min(c, 1.0))
    meta1 = np.stack(np.divmod(np.arange(j * l), l), axis=-1)
    return psi, phi, meta1


@functools.lru_cache(maxsize=8)
def _pair_table2d(j: int, l: int):
    """Static path table for 2nd order: (i1, j2, t2) with j₂ > j₁(i1)."""
    rows = []
    for i1 in range(j * l):
        j1 = i1 // l
        for j2 in range(j1 + 1, j):
            for t2 in range(l):
                rows.append((i1, j2, t2))
    if not rows:
        return (np.zeros(0, np.int64),) * 3
    a = np.asarray(rows, dtype=np.int64)
    return a[:, 0], a[:, 1], a[:, 2]


def _lowpass_subsample2(yhat: torch.Tensor, phi: torch.Tensor,
                        t: int) -> torch.Tensor:
    """ifft2(fold²(Ŷ·φ̂, T)) — low-pass then exact ↓T along both axes."""
    return torch.fft.ifft2(_spectral_fold2(yhat * phi, t),
                           dim=(-2, -1)).real


def _spectral_fold2(yhat: torch.Tensor, d: int) -> torch.Tensor:
    """Fold Ŷ to (H/d, W/d) — the spectrum of the ↓d-decimated image."""
    if d > 1:
        h, w = yhat.shape[-2], yhat.shape[-1]
        yhat = yhat.reshape(*yhat.shape[:-2], d, h // d, w).mean(dim=-3)
        yhat = yhat.reshape(*yhat.shape[:-1], d, w // d).mean(dim=-2)
    return yhat


def _subsample_filter2(f_full: np.ndarray, d: int) -> np.ndarray:
    """Exact DFT-grid restriction of an (H, W) filter to the (H/d, W/d)
    grid: the four corner blocks (low |k_y| × low |k_x|)."""
    if d == 1:
        return f_full
    h, w = f_full.shape[-2], f_full.shape[-1]
    mh, mw = h // d, w // d
    lh, lw = mh // 2 + 1, mw // 2 + 1
    rows = np.concatenate([f_full[..., :lh, :],
                           f_full[..., h - (mh - lh):, :]], axis=-2)
    return np.concatenate([rows[..., :lw],
                           rows[..., w - (mw - lw):]], axis=-1)


def _octave_decimations(j: int, t: int, oversampling: int) -> np.ndarray:
    """Per-octave pow-2 decimation: the octave-j atom band's top edge is
    ξ_j + 3/σ_j rad; keep the decimated Nyquist π/d at 2^oversampling×
    margin above it."""
    top = (XI0 + 3.0 / SIGMA0) / (1 << np.arange(j))
    d = np.ones(j, dtype=np.int64)
    for i in range(j):
        while (d[i] * 2 <= t
               and math.pi / (d[i] * 2) >= 2.0 ** oversampling * top[i]):
            d[i] *= 2
    return d


@tensor_cache(maxsize=128)
def _bank2_on(h: int, w: int, j: int, l: int, slant: float, kind: str,
              rows: tuple, d: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A filter of the (h, w, j, l, slant) bank on ``device``: φ̂ (``kind``
    'phi') or rows of ψ ('psi'), restricted to the ↓``d`` grid."""
    psi, phi, _ = scattering2d_filters(h, w, j, l, slant)
    host = phi if kind == "phi" else psi[list(rows)]
    return torch.from_numpy(np.ascontiguousarray(
        _subsample_filter2(host, d))).to(device=device, dtype=dtype)


def scattering2d(x: torch.Tensor, j: int, l: int = 8, order: int = 2,
                 subsample: int | None = None, slant: float = 0.5,
                 oversampling: int = 0) -> Scattering2DResult:
    """Wavelet scattering of an image ``x`` (..., H, W): ``j`` octaves,
    ``l`` orientations over [0, π).

    ``subsample``: output stride T (defaults to 2^j, the averaging scale;
    pass 1 to keep full resolution).  H and W must be multiples of T.
    ``slant``: angular-selectivity eccentricity of the Morlet envelope
    (smaller = more orientation-selective).  Batches over leading dims and
    differentiates (modulus subgradient 0 at 0).

    Multiresolution evaluation: octave-j paths run on a 2D grid decimated
    by a pow-2 stride d_j (a double spectral fold + short ifft2 IS the
    decimated image).  ``oversampling`` tightens parity with the
    full-resolution cascade (large values force every stride to 1); the
    default (0) keeps ~2e-3 relative agreement.  Coefficients are float64
    for float64 input, else float32.
    """
    x = as_input(x)
    if x.is_complex():
        raise ValueError("scattering2d expects a real image")
    if x.ndim < 2:
        raise ValueError("scattering2d needs at least a (H, W) image")
    h, w = x.shape[-2], x.shape[-1]
    t = (1 << j) if subsample is None else subsample
    if t < 1 or h % t or w % t:
        raise ValueError(f"subsample stride {t} must divide H={h} and W={w}")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    _, _, meta1 = scattering2d_filters(h, w, j, l, slant)
    rdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    dev = x.device

    def bank(kind, rows=(), d=1):
        return _bank2_on(h, w, j, l, float(slant), kind, rows, d, rdt, dev)

    d_oct = _octave_decimations(j, t, oversampling)
    i1, j2, t2 = _pair_table2d(j, l)
    d2p = (np.maximum(d_oct[i1 // l], d_oct[j2]) if i1.size
           else np.zeros(0, np.int64))

    xhat = torch.fft.fft2(x.to(rdt), dim=(-2, -1))
    s0 = _lowpass_subsample2(xhat, bank("phi"), t)

    s1_parts, idx_parts, u1hat_by = [], [], {}
    d1 = d_oct[meta1[:, 0]]  # per first-order path (j-major ⇒ contiguous)
    for d in sorted(set(d1.tolist())):
        idx = np.nonzero(d1 == d)[0]
        psi_g = bank("psi", tuple(idx.tolist()))
        yhat = _spectral_fold2(xhat[..., None, :, :] * psi_g, d)
        u1hat = torch.fft.fft2(torch.abs(torch.fft.ifft2(yhat, dim=(-2, -1))),
                               dim=(-2, -1))      # (..., Lg, H/d, W/d)
        s1_parts.append(_lowpass_subsample2(u1hat, bank("phi", (), d),
                                            t // d))
        idx_parts.append(idx)
        u1hat_by[d] = (idx, u1hat)
    s1 = (s1_parts[0] if len(s1_parts) == 1
          else torch.cat(s1_parts, dim=-3))
    perm = np.concatenate(idx_parts)
    if not np.array_equal(perm, np.arange(len(meta1))):
        s1 = s1.index_select(-3, _index(np.argsort(perm), dev))

    s2 = None
    if order == 2 and i1.size:
        s2_parts, pair_parts = [], []
        for d, (idx, u1hat) in sorted(u1hat_by.items()):
            pos = {a: k for k, a in enumerate(idx)}
            in_g = np.nonzero(d1[i1] == d)[0]
            for dd in sorted(set(d2p[in_g].tolist())):
                sel = in_g[d2p[in_g] == dd]
                loc = np.asarray([pos[a] for a in i1[sel]])
                rows = u1hat.index_select(-3, _index(loc, dev))
                psi2_g = bank("psi", tuple((j2[sel] * l + t2[sel]).tolist()),
                              d)
                u2hat = _spectral_fold2(rows * psi2_g, dd // d)
                u2 = torch.abs(torch.fft.ifft2(u2hat, dim=(-2, -1)))
                s2_parts.append(_lowpass_subsample2(
                    torch.fft.fft2(u2, dim=(-2, -1)), bank("phi", (), dd),
                    t // dd))
                pair_parts.append(sel)
        s2 = (s2_parts[0] if len(s2_parts) == 1
              else torch.cat(s2_parts, dim=-3))
        po = np.concatenate(pair_parts)
        if not np.array_equal(po, np.arange(len(i1))):
            s2 = s2.index_select(-3, _index(np.argsort(po), dev))
    elif order == 2:
        s2 = torch.zeros((*x.shape[:-2], 0, h // t, w // t), dtype=s1.dtype,
                         device=dev)

    pairs = (np.stack([i1, j2, t2], axis=-1) if i1.size
             else np.zeros((0, 3), dtype=np.int64))
    return Scattering2DResult(s0=s0, s1=s1, s2=s2, meta1=meta1, pairs=pairs)
