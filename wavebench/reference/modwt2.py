"""The 2D MODWT, its inverse and the universal soft-threshold image
denoise, plain.

The undecimated 2D transform of translation-invariant denoising (Coifman
and Donoho, 1995): at level j the base filters (g̃, h̃), with 2^(j−1) − 1
zeros between taps, run as circular convolutions along the rows of the
image (the last axis), then along its columns (the axis before):

    A[r, c] = Σ_k g̃[k]·LL_{j−1}[r, (c − k·2^(j−1)) mod C]
    D[r, c] = Σ_k h̃[k]·LL_{j−1}[r, (c − k·2^(j−1)) mod C]

then the same sums over r mod R give, from A, LL_j (g̃) and HL_j (h̃),
and from D, LH_j (g̃) and HH_j (h̃); LL_0 is the image.  A band's first
letter names the filter down the columns (over r), its second the filter
along the rows (over c): LH_j is g̃ over r and h̃ over c.  The bands come
in the order (LH_j, HL_j, HH_j) for j = 1 … L, then LL_L.

The inverse runs the adjoints from LL_L down:

    LL_{j−1} = Aᵀ_g(Aᵀ_g·LL_j + Aᵀ_h·HL_j) + Aᵀ_h(Aᵀ_g·LH_j + Aᵀ_h·HH_j)

with the inner adjoints along the columns and the outer along the rows,
each Aᵀ_f·y[n] = Σ_k f[k]·y[(n + k·2^(j−1)) mod N].

The denoise (Donoho and Johnstone, 1994, in two dimensions): σ =
median(|HH_1|)/0.6745 over the image's R·C values (the mean of the two
middle values for an even count), t = σ·√(2·ln(R·C)), every one of the
3L detail bands soft-shrunk, sign(w)·max(|w| − t, 0), LL_L kept, then
the inverse.  No departure from that description.

Everything is float64 on the input's device, one image at a time, so a
2048 × 2048 image takes some hundreds of MiB beside the program's
state.
"""
from __future__ import annotations

import math

import torch

from .modwt import median


def _pair(x: torch.Tensor, filters, d: int, dim: int, adjoint=False):
    """(Σ_k g[k]·x rolled, Σ_k h[k]·x rolled) along ``dim``: rolled by
    +k·d for the transform, by −k·d for its adjoint."""
    g, h = filters
    sign = -1 if adjoint else 1
    a = torch.zeros_like(x)
    b = torch.zeros_like(x)
    for k in range(len(g)):
        r = torch.roll(x, sign * k * d, dims=dim)
        a += g[k] * r
        b += h[k] * r
    return a, b


def _adjoint(lo: torch.Tensor, hi: torch.Tensor, filters, d: int, dim: int
             ) -> torch.Tensor:
    """Aᵀ_g·lo + Aᵀ_h·hi along ``dim``."""
    g, h = filters
    out = torch.zeros_like(lo)
    for k in range(len(g)):
        out += torch.roll(g[k] * lo + h[k] * hi, -k * d, dims=dim)
    return out


def modwt2(image: torch.Tensor, filters, level: int) -> torch.Tensor:
    """(3·level + 1, R, C) float64 bands of one (R, C) image."""
    ll = image.double()
    bands = []
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        a, dh = _pair(ll, filters, d, -1)        # along each row
        ll, hl = _pair(a, filters, d, -2)        # down each column
        lh, hh = _pair(dh, filters, d, -2)
        bands += [lh, hl, hh]
    bands.append(ll)
    return torch.stack(bands)


def imodwt2(bands: torch.Tensor, filters) -> torch.Tensor:
    """The (R, C) image whose 2D MODWT is ``bands`` (3L + 1, R, C)."""
    level = (bands.shape[0] - 1) // 3
    ll = bands[3 * level].double()
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        lh, hl, hh = (bands[3 * (j - 1) + k].double() for k in range(3))
        a = _adjoint(ll, hl, filters, d, -2)
        dh = _adjoint(lh, hh, filters, d, -2)
        ll = _adjoint(a, dh, filters, d, -1)
    return ll


def threshold(hh1: torch.Tensor) -> torch.Tensor:
    """The universal threshold σ·√(2·ln(R·C)) of one image from its finest
    diagonal band HH_1 (R, C)."""
    n = hh1.numel()
    sigma = median(hh1.abs().reshape(-1)) / 0.6745
    return sigma * math.sqrt(2.0 * math.log(n))


def denoise(image: torch.Tensor, filters, level: int) -> torch.Tensor:
    """The denoised (R, C) image, float64."""
    bands = modwt2(image, filters, level)
    t = threshold(bands[2])
    details = bands[:3 * level]
    details = torch.sign(details) * torch.clamp_min(details.abs() - t, 0.0)
    return imodwt2(torch.cat([details, bands[3 * level:]]), filters)


def denoise_images(x: torch.Tensor, filters, level: int) -> torch.Tensor:
    """:func:`denoise` of each image of a (B, R, C) stack, one at a time."""
    return torch.stack([denoise(im, filters, level) for im in x])
