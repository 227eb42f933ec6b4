"""PyWavelets-style coefficient-list API.

Counterpart of ``jwave_pro_tpu/ops/pywt_compat.py``; same semantics and
names.  The flat ``[approx | detail]`` prefix layout (the reference's
convention) is exact but unfamiliar to pywt users; these helpers re-express
it as the ``wavedec``-style list ``[cA_L, cD_L, ..., cD_1]`` with periodic
boundary semantics (the library's circular convolution ≡ pywt
``mode='periodization'`` up to the filter-phase convention).
"""
from __future__ import annotations

import torch

from ..utils.device import as_signal
from ..utils.validation import exponent
from ..wavelets.base import DiscreteWavelet
from .fwt import analysis_step, fwt, ifwt, synthesis_step
from .wpt import _step2, _synth2

__all__ = ["dwt", "idwt", "dwt2", "idwt2", "dwt3", "idwt3",
           "wavedec", "waverec", "wavedec2", "waverec2",
           "wavedec3", "waverec3", "coeffs_to_flat", "flat_to_coeffs"]


def dwt(x: torch.Tensor, wavelet: DiscreteWavelet):
    """Single-level DWT: ``x (..., N) → (cA, cD)``, each ``(..., N/2)``.

    The pywt-style pair view of one :func:`analysis_step` (the reference's
    per-level ``Wavelet.forward``, ``Wavelet.java:236-260``); periodic
    boundaries.  N must be even (pywt pads odd input; this does not).
    """
    x = as_signal(x)
    if x.shape[-1] % 2:
        raise ValueError(
            f"dwt requires an even last-axis length, got {x.shape[-1]}")
    y = analysis_step(x, wavelet)
    half = y.shape[-1] // 2
    return y[..., :half], y[..., half:]


def idwt(ca: torch.Tensor, cd: torch.Tensor, wavelet: DiscreteWavelet
         ) -> torch.Tensor:
    """Inverse of :func:`dwt`: ``(cA, cD) → (..., 2·len(cA))``."""
    ca, cd = as_signal(ca), as_signal(cd)
    if ca.shape[-1] != cd.shape[-1]:
        raise ValueError(
            f"cA and cD must have equal last-axis lengths, got "
            f"{ca.shape[-1]} and {cd.shape[-1]}")
    return synthesis_step(torch.cat([ca, cd], dim=-1), wavelet)


def flat_to_coeffs(y: torch.Tensor, level: int) -> list[torch.Tensor]:
    """Split a flat FWT array into ``[cA_L, cD_L, ..., cD_1]`` views."""
    y = as_signal(y)
    n = y.shape[-1]
    out = [y[..., :n >> level]]
    for j in range(level, 0, -1):
        out.append(y[..., n >> j:n >> (j - 1)])
    return out


def coeffs_to_flat(coeffs: list[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`flat_to_coeffs`."""
    return torch.cat([as_signal(c) for c in coeffs], dim=-1)


def wavedec(x: torch.Tensor, wavelet: DiscreteWavelet, level=None
            ) -> list[torch.Tensor]:
    """Multi-level decomposition as a pywt-style coefficient list."""
    x = as_signal(x)
    lvl = exponent(x.shape[-1]) if level is None else int(level)
    return flat_to_coeffs(fwt(x, wavelet, lvl), lvl)


def waverec(coeffs: list[torch.Tensor], wavelet: DiscreteWavelet
            ) -> torch.Tensor:
    """Reconstruct from a pywt-style coefficient list."""
    return ifwt(coeffs_to_flat(coeffs), wavelet, len(coeffs) - 1)


def dwt2(x: torch.Tensor, wavelet: DiscreteWavelet):
    """Single-level 2D DWT: ``(..., R, C) → (cA, (cH, cV, cD))``.

    pywt semantics on the library's periodic boundary: cH = horizontal
    detail (wavelet along rows, scaling along columns), cV the transpose,
    cD diagonal.  Both R and C must be even.
    """
    x = as_signal(x)
    r, c = x.shape[-2], x.shape[-1]
    if r % 2 or c % 2:
        raise ValueError(f"dwt2 requires even image sides, got ({r}, {c})")
    y = _step2(x, wavelet, r, c)
    hr, hc = r // 2, c // 2
    ca = y[..., :hr, :hc]
    cv = y[..., :hr, hc:]   # scaling@rows · wavelet@cols → vertical edges
    ch = y[..., hr:, :hc]   # wavelet@rows · scaling@cols → horizontal edges
    cd = y[..., hr:, hc:]
    return ca, (ch, cv, cd)


def idwt2(ca: torch.Tensor, details, wavelet: DiscreteWavelet
          ) -> torch.Tensor:
    """Inverse of :func:`dwt2`."""
    ca, ch, cv, cd = (as_signal(a) for a in (ca, *details))
    for name, a in (("cH", ch), ("cV", cv), ("cD", cd)):
        if a.shape != ca.shape:
            raise ValueError(f"{name} shape {tuple(a.shape)} != cA shape "
                             f"{tuple(ca.shape)}")
    y = torch.cat([torch.cat([ca, cv], dim=-1), torch.cat([ch, cd], dim=-1)],
                  dim=-2)
    return _synth2(y, wavelet, y.shape[-2], y.shape[-1])


def _default_depth(dims, wavelet: DiscreteWavelet) -> int:
    """Halve while every side stays even and at least as wide as the
    wavelet's minimum transform length."""
    floor = max(2, wavelet.transform_wavelength)
    level = 0
    dims = list(dims)
    while all(s % 2 == 0 for s in dims) and min(dims) >= floor:
        level += 1
        dims = [s // 2 for s in dims]
    return level


def wavedec2(x: torch.Tensor, wavelet: DiscreteWavelet, level=None):
    """Multi-level 2D decomposition, Mallat convention (only cA recursed):
    ``[cA_L, (cH_L, cV_L, cD_L), ..., (cH_1, cV_1, cD_1)]``.

    This is pywt's octave-band image DWT — distinct from :func:`.fwt.fwt2`,
    the reference's rectangular rows-then-columns convention
    (``BasicTransform.java:361-399``).
    """
    x = as_signal(x)
    if level is None:
        level = _default_depth(x.shape[-2:], wavelet)
    level = int(level)
    if level < 1:
        raise ValueError("level must be >= 1")
    out = []
    ca = x
    for _ in range(level):
        ca, det = dwt2(ca, wavelet)
        out.append(det)
    out.append(ca)
    return list(reversed(out))


def waverec2(coeffs, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Reconstruct from a :func:`wavedec2` coefficient list."""
    ca = as_signal(coeffs[0])
    for det in coeffs[1:]:
        ca = idwt2(ca, det, wavelet)
    return ca


# ---------------------------------------------------------------------------
# 3D (pywt dwtn/wavedec3 convention; octant keys read (depth, row, col))
# ---------------------------------------------------------------------------

_DET3_KEYS = ("aad", "ada", "add", "daa", "dad", "dda", "ddd")


def _astep_axis(x: torch.Tensor, wavelet: DiscreteWavelet, axis: int,
                step=analysis_step) -> torch.Tensor:
    if axis == -1:
        return step(x, wavelet)
    return torch.swapaxes(step(torch.swapaxes(x, -1, axis), wavelet),
                          -1, axis)


def dwt3(x: torch.Tensor, wavelet: DiscreteWavelet):
    """Single-level 3D DWT: ``(..., D, R, C) → (cAAA, {detail octants})``.

    Separable tensor product of three :func:`analysis_step` passes (the 3D
    analog of ``BasicTransform.java:509-566``, one level).  Detail octants
    are keyed by the pywt ``dwtn`` convention — three letters reading
    (depth, row, col), ``a`` = scaling half, ``d`` = wavelet half.  All
    three trailing axes must be even.
    """
    x = as_signal(x)
    d, r, c = x.shape[-3:]
    if d % 2 or r % 2 or c % 2:
        raise ValueError(
            f"dwt3 requires even volume sides, got ({d}, {r}, {c})")
    y = x
    for ax in (-1, -2, -3):
        y = _astep_axis(y, wavelet, ax)

    def octant(key: str) -> torch.Tensor:
        sl = [slice(0, size // 2) if letter == "a" else slice(size // 2, size)
              for letter, size in zip(key, (d, r, c))]
        return y[..., sl[0], sl[1], sl[2]]

    return octant("aaa"), {k: octant(k) for k in _DET3_KEYS}


def idwt3(caaa: torch.Tensor, details, wavelet: DiscreteWavelet
          ) -> torch.Tensor:
    """Inverse of :func:`dwt3`: ``(cAAA, {7 octants}) → (..., D, R, C)``."""
    caaa = as_signal(caaa)
    missing = [k for k in _DET3_KEYS if k not in details]
    if missing:
        raise ValueError(f"idwt3 missing detail octants: {missing}")
    octs = {"aaa": caaa}
    for k in _DET3_KEYS:
        a = as_signal(details[k])
        if a.shape != caaa.shape:
            raise ValueError(f"octant {k!r} shape {tuple(a.shape)} != cAAA "
                             f"shape {tuple(caaa.shape)}")
        octs[k] = a

    # stitch the octants back into the cube: columns, then rows, then depth
    def cat(prefix: str, axis: int) -> torch.Tensor:
        if len(prefix) == 3:
            return octs[prefix]
        return torch.cat([cat(prefix + "a", axis + 1),
                          cat(prefix + "d", axis + 1)], dim=axis - 3)

    y = cat("", 0)
    for ax in (-3, -2, -1):
        y = _astep_axis(y, wavelet, ax, step=synthesis_step)
    return y


def wavedec3(x: torch.Tensor, wavelet: DiscreteWavelet, level=None):
    """Multi-level 3D decomposition, Mallat convention (only cAAA
    recursed): ``[cAAA_L, {dets_L}, ..., {dets_1}]`` (pywt ``wavedec3``
    layout)."""
    x = as_signal(x)
    if level is None:
        level = _default_depth(x.shape[-3:], wavelet)
    level = int(level)
    if level < 1:
        raise ValueError("level must be >= 1")
    out = []
    ca = x
    for _ in range(level):
        ca, det = dwt3(ca, wavelet)
        out.append(det)
    out.append(ca)
    return list(reversed(out))


def waverec3(coeffs, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Reconstruct from a :func:`wavedec3` coefficient list."""
    ca = as_signal(coeffs[0])
    for det in coeffs[1:]:
        ca = idwt3(ca, det, wavelet)
    return ca
