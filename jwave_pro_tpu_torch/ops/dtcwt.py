"""Dual-Tree Complex Wavelet Transform — near-analytic, near-shift-invariant.

Counterpart of ``jwave_pro_tpu/ops/dtcwt.py``; same semantics and names.
The DTCWT (Kingsbury 1998-2001; Selesnick, Baraniuk & Kingsbury 2005) runs
two parallel orthonormal DWT trees whose wavelets form an approximate
Hilbert pair, ψ_b ≈ H[ψ_a]; the complex coefficients w = (w_a + i·w_b)/√2
then have a smooth, nearly shift-invariant magnitude at only 2× redundancy.

**Q-shift filters are designed here, not transcribed** — Selesnick's
common-factor construction (IEEE SPL 2002 / IEEE TSP 2002):

    h_a(z) = F(z)·D(z),      h_b(z) = F(z)·z^{-L}·D(1/z)

where D is the degree-L Thiran maximally-flat fractional-delay polynomial
for τ = ½ and F = (1+z⁻¹)^K·G carries K vanishing moments.  Both trees
share the same product filter H(z)H(1/z), so one halfband linear solve and
one spectral factorization (numpy, host float64, cached) give an
orthonormal pair: perfect reconstruction is exact in each tree.

Each tree's levels run on the decimated tier's banded block-pair matmuls
(``ops/fwt.py``: ``_analysis_fused_matmul`` / ``_synthesis_fused_matmul``
with the per-level filter sequence ``[level1] + [qshift]·(J−1)``, cuBLAS
on the card, products and their gradients pinned to IEEE float32), single
steps where the fused form does not fit.  Level 1 uses a standard
orthonormal wavelet with tree b offset by one input sample (the Kingsbury
trick: a 1-sample delay before ↓2 is a half-sample offset after it), a
circular roll.
"""
from __future__ import annotations

import functools
import math
import typing
from math import comb

import numpy as np
import torch

from ..utils.device import as_input
from ..wavelets.base import DiscreteWavelet, qmf_orthonormal
from .denoise import _median
from .fwt import (_BLK, _analysis_fused_matmul, _seq_fits_analysis,
                  _seq_fits_synthesis, _synthesis_fused_matmul,
                  analysis_step, synthesis_step)

__all__ = ["DTCWTResult", "dtcwt", "idtcwt", "DTCWT2Result", "dtcwt2",
           "idtcwt2", "dtcwt_denoise", "dtcwt2_denoise", "qshift_wavelets",
           "qshift_design"]


def _thiran_half_delay(l: int) -> np.ndarray:
    """Degree-``l`` Thiran polynomial D: z^{-l}D(1/z)/D(z) ≈ e^{-jω/2}
    (maximally-flat fractional-delay allpass for τ = ½, Thiran 1971)."""
    d = np.zeros(l + 1)
    d[0] = 1.0
    tau = 0.5
    for k in range(1, l + 1):
        p = 1.0
        for n in range(l + 1):
            p *= (tau - l + n) / (tau - l + k + n)
        d[k] = (-1) ** k * comb(l, k) * p
    return d


def _sym_conv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One-sided convolution of symmetric (centered) Laurent coefficients."""
    fa = np.concatenate([a[::-1], a[1:]])
    fb = np.concatenate([b[::-1], b[1:]])
    return np.convolve(fa, fb)[len(a) + len(b) - 2:]


@functools.lru_cache(maxsize=16)
def qshift_design(k: int = 4, l: int = 3):
    """Design the common-factor q-shift lowpass pair → (h0a, h0b) float64.

    ``k``: vanishing moments; ``l``: Thiran order (half-sample-delay
    flatness); each filter has 2(k + l) taps.  Steps: (1) halfband linear
    solve for the symmetric factor U with P = (2+z+z⁻¹)^K·D(z)D(1/z)·U(z)
    halfband; (2) spectral factorization U = G·G(1/z) (roots inside the
    unit circle); (3) h0a = (1+z⁻¹)^K G D, h0b = (1+z⁻¹)^K G rev(D), both
    normalized to unit L2.  Raises if U(ω) < 0.
    """
    if k < 1 or l < 1:
        raise ValueError("need k >= 1 vanishing moments and l >= 1")
    d = _thiran_half_delay(l)
    r = np.array([np.dot(d[:len(d) - m], d[m:]) for m in range(l + 1)])
    b = np.array([comb(2 * k, k + m) for m in range(k + 1)], float)
    m_u = k + l - 1
    br = _sym_conv(b, r)
    n_eq = k + l
    a_mat = np.zeros((n_eq, m_u + 1))
    for j in range(m_u + 1):
        u = np.zeros(m_u + 1)
        u[j] = 1.0
        p = _sym_conv(br, u)
        for i in range(n_eq):
            a_mat[i, j] = p[2 * i] if 2 * i < len(p) else 0.0
    rhs = np.zeros(n_eq)
    rhs[0] = 1.0
    u = np.linalg.solve(a_mat, rhs)
    w = np.linspace(0, np.pi, 8192)
    u_w = u[0] + 2 * sum(u[m] * np.cos(m * w) for m in range(1, m_u + 1))
    if u_w.min() < -1e-12:
        raise ValueError(f"common-factor design infeasible (U min "
                         f"{u_w.min():.2e}) for k={k}, l={l}")
    fu = np.concatenate([u[::-1], u[1:]])
    roots = np.roots(fu)
    g = np.real(np.poly(roots[np.abs(roots) < 1.0]))
    f = g.copy()
    for _ in range(k):
        f = np.convolve(f, [1.0, 1.0])
    h0a = np.convolve(f, d)
    h0b = np.convolve(f, d[::-1])
    h0a /= np.linalg.norm(h0a)
    h0b /= np.linalg.norm(h0b)
    return h0a, h0b


@functools.lru_cache(maxsize=16)
def qshift_wavelets(k: int = 4, l: int = 3):
    """The designed q-shift pair as :class:`DiscreteWavelet` objects
    (alternating-flip QMF highpass, reconstruction = decomposition)."""
    h0a, h0b = qshift_design(k, l)
    wa = qmf_orthonormal(f"QShift-a (k={k}, l={l})", h0a, family="QShift")
    wb = qmf_orthonormal(f"QShift-b (k={k}, l={l})", h0b, family="QShift")
    return wa, wb


class DTCWTResult(typing.NamedTuple):
    """Dual-tree coefficients; all tensors share the input's leading dims.

    ``highpass``: tuple over levels 1..J of complex (..., N/2^j) subbands
    w = (w_a + i·w_b)/√2 — complex64, or complex128 for float64 input;
    Σ_j ‖w_j‖² + (‖low_a‖² + ‖low_b‖²)/2 = ‖x‖² exactly.
    ``lowpass_a``/``lowpass_b``: the two trees' real V_J rows (..., N/2^J).
    """

    highpass: tuple
    lowpass_a: torch.Tensor
    lowpass_b: torch.Tensor

    @property
    def magnitudes(self):
        return tuple(torch.abs(w) for w in self.highpass)


def _tree_params(level1: DiscreteWavelet | None, k: int, l: int):
    if level1 is None:
        from ..wavelets.families import wavelet as _lookup
        level1 = _lookup("Symlet 8")
    wa, wb = qshift_wavelets(k, l)
    return level1, wa, wb


def _real_input(x, what: str) -> torch.Tensor:
    """``x`` as a real floating tensor: integer input in float32 (as the
    JAX package casts it), complex input refused."""
    x = as_input(x)
    if x.is_complex():
        raise ValueError(f"{what} expects a real "
                         f"{'image' if what == 'dtcwt2' else 'signal'}")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return x


def _cplx(re: torch.Tensor, im: torch.Tensor, scale: float) -> torch.Tensor:
    """(re + i·im)·scale: complex128 from float64, else complex64 (a
    half-precision tree is widened first, as JAX promotes it)."""
    if re.dtype not in (torch.float32, torch.float64):
        re, im = re.float(), im.float()
    return torch.complex(re, im) * scale


def dtcwt(x: torch.Tensor, level: int, level1: DiscreteWavelet | None = None,
          k: int = 4, l: int = 3) -> DTCWTResult:
    """Dual-tree CWT of real ``x`` (..., N) to depth ``level``.

    ``level1``: orthonormal wavelet for the first stage (default Symlet 8;
    tree b runs it one sample late — the half-sample offset after ↓2).
    ``k``/``l``: q-shift design parameters for levels ≥ 2.  N must be
    divisible by 2^level (circular boundary, like the FWT tier).  Batches
    over leading dims and differentiates; the round trip with
    :func:`idtcwt` is exact (each tree is orthonormal).
    """
    x = _real_input(x, "dtcwt")
    n = x.shape[-1]
    if level < 1:
        raise ValueError("level must be >= 1")
    if n % (1 << level):
        raise ValueError(f"N={n} must be divisible by 2^level={1 << level}")
    w1, wa, wb = _tree_params(level1, k, l)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)

    seq_a = [w1] + [wa] * (level - 1)
    seq_b = [w1] + [wb] * (level - 1)
    la, lb = x, torch.roll(x, -1, dims=-1)
    highs = []
    idx = 0
    h = n
    while idx < level:
        lf = 1
        if h % _BLK == 0 and max(w.length for w in seq_a[idx:]) <= _BLK:
            for cand in range(min(level - idx, 8), 1, -1):
                if _seq_fits_analysis(tuple(seq_a[idx:idx + cand])):
                    lf = cand
                    break
        if lf > 1:
            la, da = _analysis_fused_matmul(la, tuple(seq_a[idx:idx + lf]))
            lb, db = _analysis_fused_matmul(lb, tuple(seq_b[idx:idx + lf]))
            highs.extend(_cplx(a, b, inv_sqrt2) for a, b in zip(da, db))
            h >>= lf
        else:
            ya = analysis_step(la, seq_a[idx])
            yb = analysis_step(lb, seq_b[idx])
            la, lb = ya[..., :h // 2], yb[..., :h // 2]
            highs.append(_cplx(ya[..., h // 2:], yb[..., h // 2:],
                               inv_sqrt2))
            h //= 2
        idx += lf
    return DTCWTResult(highpass=tuple(highs), lowpass_a=la, lowpass_b=lb)


def idtcwt(res: DTCWTResult, level1: DiscreteWavelet | None = None,
           k: int = 4, l: int = 3) -> torch.Tensor:
    """Inverse DTCWT: exact reconstruction (average of the two trees).

    Pass the same ``level1``/``k``/``l`` as the forward.  Real and
    imaginary parts of each complex subband re-scale by √2 back into the
    per-tree coefficients (in the lowpass rows' dtype); each orthonormal
    tree inverts exactly, and averaging the two reconstructions keeps the
    inverse exact for any coefficient change that treats the trees
    symmetrically (e.g. magnitude shrinkage of w).
    """
    w1, wa, wb = _tree_params(level1, k, l)
    sqrt2 = math.sqrt(2.0)
    level = len(res.highpass)
    seq_a = [w1] + [wa] * (level - 1)
    seq_b = [w1] + [wb] * (level - 1)
    la, lb = as_input(res.lowpass_a), as_input(res.lowpass_b)

    def tree(w, part):
        return (sqrt2 * part(w)).to(la.dtype)

    j = level  # deepest remaining synthesis step
    while j >= 1:
        lf = 1
        if max(w.length for w in seq_a[:j]) <= _BLK:
            for cand in range(min(j, 8), 1, -1):
                out_w = res.highpass[j - cand].shape[-1] * 2
                if (out_w % _BLK == 0
                        and _seq_fits_synthesis(tuple(seq_a[j - cand:j]))):
                    lf = cand
                    break
        if lf > 1:
            segs = res.highpass[j - lf:j][::-1]  # deepest first
            la = _synthesis_fused_matmul(
                la, [tree(w, torch.real) for w in segs],
                tuple(seq_a[j - lf:j]))
            lb = _synthesis_fused_matmul(
                lb, [tree(w, torch.imag) for w in segs],
                tuple(seq_b[j - lf:j]))
        else:
            w = res.highpass[j - 1]
            la = synthesis_step(torch.cat([la, tree(w, torch.real)], dim=-1),
                                seq_a[j - 1])
            lb = synthesis_step(torch.cat([lb, tree(w, torch.imag)], dim=-1),
                                seq_b[j - 1])
        j -= lf
    return 0.5 * (la + torch.roll(lb, 1, dims=-1))


class DTCWT2Result(typing.NamedTuple):
    """2D dual-tree coefficients.

    ``highpass``: tuple over levels of complex (..., 6, H/2^j, W/2^j)
    subbands, type-major: [HL+, HL−, LH+, LH−, HH+, HH−] — each type's
    (z+, z−) pair selects one diagonal-frequency sign, giving six
    orientations ≈ {∓15°, ∓75°, ∓45°} off horizontal.
    ``lowpass``: the four trees' real LL_J rows, stacked
    (..., 4, H/2^J, W/2^J) in (aa, ab, ba, bb) order (row tree, col tree).
    Energy: ‖x‖² = ½·Σ‖highpass‖² + ¼·‖lowpass‖².
    """

    highpass: tuple
    lowpass: torch.Tensor

    @property
    def magnitudes(self):
        return tuple(torch.abs(w) for w in self.highpass)


def _step2(x, wrow, wcol, roll_row=False, roll_col=False):
    """One separable analysis level: (..., H, W) → (LL, HL, LH, HH).

    ``roll_*``: the level-1 tree-b one-sample offset on that axis.
    Band letters are (row filter, col filter); rows = axis −2.
    """
    if roll_col:
        x = torch.roll(x, -1, dims=-1)
    y = analysis_step(x, wcol)                     # filter the col axis
    w = y.shape[-1] // 2
    lo_c, hi_c = y[..., :w], y[..., w:]
    if roll_row:
        lo_c = torch.roll(lo_c, -1, dims=-2)
        hi_c = torch.roll(hi_c, -1, dims=-2)
    ylo = analysis_step(lo_c.transpose(-1, -2), wrow).transpose(-1, -2)
    yhi = analysis_step(hi_c.transpose(-1, -2), wrow).transpose(-1, -2)
    h = ylo.shape[-2] // 2
    return (ylo[..., :h, :], ylo[..., h:, :],
            yhi[..., :h, :], yhi[..., h:, :])     # LL, HL, LH, HH


def _istep2(ll, hl, lh, hh, wrow, wcol, roll_row=False, roll_col=False):
    """Adjoint of :func:`_step2`."""
    ylo = torch.cat([ll, hl], dim=-2)
    yhi = torch.cat([lh, hh], dim=-2)
    lo_c = synthesis_step(ylo.transpose(-1, -2), wrow).transpose(-1, -2)
    hi_c = synthesis_step(yhi.transpose(-1, -2), wrow).transpose(-1, -2)
    if roll_row:
        lo_c = torch.roll(lo_c, 1, dims=-2)
        hi_c = torch.roll(hi_c, 1, dims=-2)
    x = synthesis_step(torch.cat([lo_c, hi_c], dim=-1), wcol)
    if roll_col:
        x = torch.roll(x, 1, dims=-1)
    return x


def _combine6(bands):
    """Four trees' (HL, LH, HH) → six oriented complex subbands.

    ``bands[(u, v)]`` = (HL, LH, HH) of row-tree u, col-tree v.  For each
    type the (aa, bb) pair forms the real part and (ba, ab) the imaginary
    part of two conjugate-orientation bands (Kingsbury's sum/difference):
    z± = ((aa ∓ bb) + i(ba ± ab))/2.
    """
    out = []
    for t in range(3):
        p, s = bands[("a", "a")][t], bands[("b", "b")][t]
        r, q = bands[("b", "a")][t], bands[("a", "b")][t]
        out.append(_cplx(p - s, r + q, 0.5))
        out.append(_cplx(p + s, r - q, 0.5))
    return out


def _split6(z6, dtype):
    """Adjoint of :func:`_combine6`: six complex bands → four trees (in
    ``dtype``, the lowpass rows')."""
    bands = {t: [] for t in _TREES}
    for t in range(3):
        z1, z2 = z6[2 * t], z6[2 * t + 1]
        bands[("a", "a")].append((z1.real + z2.real).to(dtype))
        bands[("b", "b")].append((z2.real - z1.real).to(dtype))
        bands[("b", "a")].append((z1.imag + z2.imag).to(dtype))
        bands[("a", "b")].append((z1.imag - z2.imag).to(dtype))
    return bands


_TREES = (("a", "a"), ("a", "b"), ("b", "a"), ("b", "b"))


def dtcwt2(x: torch.Tensor, level: int, level1: DiscreteWavelet | None = None,
           k: int = 4, l: int = 3) -> DTCWT2Result:
    """2D dual-tree CWT of a real image (..., H, W): six oriented,
    near-analytic complex subbands per level at 4× redundancy.

    Four separable wavelet trees (row tree × col tree ∈ {a, b}²) run
    through the decimated tier's step matmuls; per level the four
    (HL, LH, HH) triplets combine into six single-quadrant complex
    subbands.  H, W divisible by 2^level; exact reconstruction via
    :func:`idtcwt2`.
    """
    x = _real_input(x, "dtcwt2")
    if x.ndim < 2:
        raise ValueError("dtcwt2 needs at least a (H, W) image")
    h, w = x.shape[-2], x.shape[-1]
    if level < 1:
        raise ValueError("level must be >= 1")
    if h % (1 << level) or w % (1 << level):
        raise ValueError(
            f"H={h}, W={w} must be divisible by 2^level={1 << level}")
    w1, wa, wb = _tree_params(level1, k, l)
    by_tree = {"a": wa, "b": wb}

    lows = {t: x for t in _TREES}
    highs = []
    for j in range(1, level + 1):
        bands = {}
        for (u, v) in _TREES:
            if j == 1:
                ll, hl, lh, hh = _step2(lows[(u, v)], w1, w1,
                                        roll_row=(u == "b"),
                                        roll_col=(v == "b"))
            else:
                ll, hl, lh, hh = _step2(lows[(u, v)], by_tree[u], by_tree[v])
            lows[(u, v)] = ll
            bands[(u, v)] = (hl, lh, hh)
        highs.append(torch.stack(_combine6(bands), dim=-3))
    return DTCWT2Result(highpass=tuple(highs),
                        lowpass=torch.stack([lows[t] for t in _TREES],
                                            dim=-3))


def idtcwt2(res: DTCWT2Result, level1: DiscreteWavelet | None = None,
            k: int = 4, l: int = 3) -> torch.Tensor:
    """Inverse 2D dual-tree CWT — exact (average of the four trees)."""
    w1, wa, wb = _tree_params(level1, k, l)
    by_tree = {"a": wa, "b": wb}
    low = as_input(res.lowpass)
    lows = {t: low[..., i, :, :] for i, t in enumerate(_TREES)}
    level = len(res.highpass)
    for j in range(level, 0, -1):
        z6 = [res.highpass[j - 1][..., i, :, :] for i in range(6)]
        bands = _split6(z6, low.dtype)
        for (u, v) in _TREES:
            hl, lh, hh = bands[(u, v)]
            if j == 1:
                lows[(u, v)] = _istep2(lows[(u, v)], hl, lh, hh, w1, w1,
                                       roll_row=(u == "b"),
                                       roll_col=(v == "b"))
            else:
                lows[(u, v)] = _istep2(lows[(u, v)], hl, lh, hh,
                                       by_tree[u], by_tree[v])
    return 0.25 * sum(lows.values())


def _shrink_magnitude(w: torch.Tensor, t, mode: str) -> torch.Tensor:
    """Shrink |w| keeping the phase — the complex analog of soft/hard
    thresholding."""
    mag = torch.abs(w)
    if mode == "soft":
        new = torch.clamp_min(mag - t, 0.0)
    elif mode == "hard":
        new = torch.where(mag > t, mag, 0.0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return w * (new / torch.clamp_min(mag, torch.finfo(mag.dtype).tiny))


def _universal_complex_threshold(w1: torch.Tensor, n: int, axes
                                 ) -> torch.Tensor:
    """σ·√(2·ln N) with σ from the MAD of the tree-a level-1 details
    (√2·Re w — an orthonormal tree passes input noise through at unit
    gain); medians by the midpoint rule, as ``jnp.median``."""
    d = math.sqrt(2.0) * w1.real
    k = 1 if isinstance(axes, int) else len(axes)
    med = _median(d, axes)
    for _ in range(k):
        med = med[..., None]
    sigma = _median(torch.abs(d - med), axes)
    for _ in range(k):
        sigma = sigma[..., None]
    return sigma / 0.6745 * math.sqrt(2.0 * math.log(n))


def _threshold(threshold, like: torch.Tensor):
    """A caller's threshold: a number as it is, anything else as a tensor
    on ``like``'s device."""
    if isinstance(threshold, (int, float)):
        return threshold
    return torch.as_tensor(threshold, device=like.device)


def dtcwt_denoise(x: torch.Tensor, level: int, mode: str = "soft",
                  threshold=None, level1: DiscreteWavelet | None = None,
                  k: int = 4, l: int = 3) -> torch.Tensor:
    """Denoise by dual-tree magnitude shrinkage — near shift-invariant at
    2× redundancy.

    ``threshold`` defaults to the universal threshold from the level-1
    complex band (σ via MAD of the tree-a details); pass a value or tensor
    to override.  Magnitudes shrink, phases are kept, and the exact
    inverse averages the two trees.
    """
    x = _real_input(x, "dtcwt")
    r = dtcwt(x, level, level1, k, l)
    if threshold is None:
        threshold = _universal_complex_threshold(
            r.highpass[0], x.shape[-1], axes=-1)
    else:
        threshold = _threshold(threshold, r.lowpass_a)
    highs = tuple(_shrink_magnitude(h, threshold, mode) for h in r.highpass)
    return idtcwt(DTCWTResult(highs, r.lowpass_a, r.lowpass_b), level1, k, l)


def dtcwt2_denoise(x: torch.Tensor, level: int, mode: str = "soft",
                   threshold=None, level1: DiscreteWavelet | None = None,
                   k: int = 4, l: int = 3) -> torch.Tensor:
    """2D dual-tree denoising: magnitude shrinkage over the six oriented
    complex subbands (σ from the finest level's HH⁺ band MAD)."""
    x = _real_input(x, "dtcwt2")
    r = dtcwt2(x, level, level1, k, l)
    if threshold is None:
        n = x.shape[-2] * x.shape[-1]
        threshold = _universal_complex_threshold(
            r.highpass[0][..., 4, :, :], n, axes=(-2, -1))[..., None, :, :]
    else:
        threshold = _threshold(threshold, r.lowpass)
    highs = tuple(_shrink_magnitude(h, threshold, mode) for h in r.highpass)
    return idtcwt2(DTCWT2Result(highs, r.lowpass), level1, k, l)
