"""Pruned-band CWT: per-scale spectral support + factorized zoom-iDFT.

Counterpart of ``jwave_pro_tpu/ops/cwt_banded.py``; same semantics and
names.  The multiplier M_s(ω) = conj(√a·ψ̂(a·ω)) of the FFT path is ~zero
outside a band of width O(P/a) (Gaussian/polynomial ψ̂ decay), so each
coefficient row is computed from only its band:

    c_s[n] = e^{2πi·o_s·n/P} · Σ_{b<B_s} Y_s[b] · e^{2πi·b·n/P},
    Y_s[b] = X⁺[o_s+b] · mult_s[b]

with the band sum as a two-stage factorized DFT
(b = 128·b₂ + b₁;  n = q·T + m,  T = P/128):

    G_s[b₁, m] = Σ_{b₂} Y_s[128·b₂+b₁] · e^{2πi·b₂·m/T}      (B₂ ≤ 17)
    H_s[b₁, m] = G_s · e^{2πi·b₁·m/P} · e^{2πi·o_s·m/P}
    z_s[m, q]  = Σ_{b₁} H_s[b₁, m] · e^{2πi·b₁·q/128}        (one batched
                                                              128-contraction)
    c_s[qT+m]  = z_s[m, q] · e^{2πi·o_s·q·T/P}

so the per-row cost is N·128 + B_s·T multiply-adds, independent of the
band width.  Each contraction is a complex product in three real ones
(Karatsuba), each a cuBLAS product on the card (``ops/fwt.py:_mm``, its
gradient in the same tier).  The per-scale band windows are one gather.

Constants (band offsets, folded multipliers, twiddles) are host numpy in
float64, planned once per (wavelet, scale grid, P, fs) (``band_plan``) and
kept on each device per dtype (``_device_plan``).

Wavelet regimes, detected from ψ̂ on the host:
  * analytic (Morlet, Paul): max|ψ̂(ω<0)| ≤ ε·peak → one-sided complex sum,
    one row per scale, weights 1/P;
  * real-even ψ̂ (Mexican Hat, even DOG): coefficients are real — one row
    per scale (half-spectrum A multiplier, weights 2/P, DC/Nyquist 1/P),
    c = Re(·);
  * general (odd DOG, Meyer's tiny asymmetry): two rows per scale (A and
    B), c = Re(row_A) + i·Re(row_B).

Precision tiers of the float32 products (``precision``): 'highest' IEEE
float32; 'high' TF32, set and restored inside the call; 'default' the
operands rounded to bfloat16 and the product accumulated in float32 (a
TF32 product of bfloat16 values is exact before its float32 sum).  A
float64 input runs in float64 whatever the tier.

Parity: identical math to ``ops/cwt.py``'s half-spectrum path up to the
ε = 1e-8 relative band truncation.  Reference semantics: the ψ̂
conj-multiply loop of ``ContinuousWaveletTransform.java:183-229``.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from ..wavelets.continuous import ContinuousWavelet
from .cwt import _psi_hat_grid
from .fwt import _mm

__all__ = ["cwt_banded_coefficients", "cwt_banded_wd", "banded_supported",
           "band_plan"]

_EPS = 1e-8          # relative ψ̂ truncation threshold
_B1 = 128            # stage-2 contraction size


def banded_supported(padded_n: int, n_out: int) -> bool:
    """Shape guard: needs P a multiple of 128 with T = P/128 ≥ 4."""
    return padded_n % _B1 == 0 and padded_n // _B1 >= 4 and n_out >= 1


class _Group:
    """Scales sharing one padded band width (b2 = width/128 blocks)."""

    __slots__ = ("offsets", "b2", "mult", "twc")

    def __init__(self, offsets, b2, mult, twc):
        self.offsets = offsets   # (Sg,) python ints — band starts
        self.b2 = b2             # band width in 128-blocks
        self.mult = mult         # (Sg, b2·128) complex128 folded multiplier
        self.twc = twc           # (Sg, 128, T) complex128 twiddle·carrier_m


@functools.lru_cache(maxsize=128)
def band_plan(wavelet: ContinuousWavelet, scales_t: tuple, padded_n: int,
              sampling_rate: float, n_out: int, eps: float = _EPS,
              derivative: bool = False):
    """Static plan: (mode, row_groups, inv_perm, e1, carr_qs, t, q).

    ``row_groups``: one list of _Group per output row set (1 for
    analytic/real, 2 for general; twice that with ``derivative``).  Scale
    order within the concatenated groups is restored by ``inv_perm``.
    Widths are padded to 128·{1,2,4,…} — bands widen symmetrically into
    the padding with their true (tiny) multiplier values.
    """
    scales = np.asarray(scales_t, dtype=np.float64)
    s_count = scales.shape[0]
    p = padded_n
    f = p // 2 + 1
    t_dim = p // _B1
    omega = 2.0 * math.pi * np.arange(f) * sampling_rate / p
    m_pos = np.conj(_psi_hat_grid(wavelet, omega, scales))
    psi_neg = _psi_hat_grid(wavelet, -omega, scales)

    peak = max(float(np.max(np.abs(m_pos))), float(np.max(np.abs(psi_neg))),
               1e-300)
    # Analytic when the negative-frequency tail is below the band-truncation
    # budget (Morlet's tail is ~3e-9·peak — "analytic" at any ε ≥ 1e-8).
    if np.max(np.abs(psi_neg[:, 1:])) <= eps * peak:
        mode = "analytic"
        mults = [m_pos / p]
    else:
        a_mult = 0.5 * (m_pos + psi_neg)            # conj-folded halves
        b_mult = -0.5j * (m_pos - psi_neg)
        a_mult[:, 0] = np.real(m_pos[:, 0])
        b_mult[:, 0] = np.imag(m_pos[:, 0])
        if p % 2 == 0:
            a_mult[:, -1] = np.real(m_pos[:, -1])
            b_mult[:, -1] = np.imag(m_pos[:, -1])
        w_half = np.full(f, 2.0 / p)
        w_half[0] = 1.0 / p
        if p % 2 == 0:
            w_half[-1] = 1.0 / p
        if np.max(np.abs(b_mult)) <= 1e-14 * peak:
            mode = "real"
            mults = [a_mult * w_half]
        else:
            mode = "general"
            mults = [a_mult * w_half, b_mult * w_half]

    if derivative:
        # ∂_t rows: multiplier iω·M shares M's band support; the Nyquist
        # bin is zeroed — iω there breaks the real-output symmetry.
        iw = 1j * (2.0 * math.pi * np.arange(f) * sampling_rate / p)
        deriv = [mu * iw for mu in mults]
        if p % 2 == 0:
            for d in deriv:
                d[:, -1] = 0.0
        mults = mults + deriv

    support = np.zeros((s_count, f))
    for mu in mults:
        support = np.maximum(support, np.abs(mu))

    by_width: dict[int, list] = {}
    for s in range(s_count):
        row = support[s]
        thr = eps * max(float(row.max()), 1e-300)
        nz = np.nonzero(row > thr)[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 1)
        width = hi - lo
        b2 = 1
        while b2 * _B1 < width:
            b2 *= 2
        b2 = min(b2, -(-f // _B1))
        bw = b2 * _B1
        lo = max(0, min(lo - (bw - width) // 2, f - bw)) if f >= bw else 0
        by_width.setdefault(b2, []).append((s, lo))

    m_axis = np.arange(t_dim)
    tw = np.exp(2j * np.pi * np.arange(_B1)[:, None] * m_axis[None, :] / p)
    # Descending width order: band width is non-increasing along an
    # ascending scale grid, so group concatenation then lands in the
    # caller's scale order and the inv_perm take is skipped.
    width_order = sorted(by_width, reverse=True)
    perm = [s for b2 in width_order for s, _ in by_width[b2]]
    inv_perm = np.argsort(np.asarray(perm, dtype=np.int64))

    row_groups = []
    for mu in mults:
        groups = []
        for b2 in width_order:
            entries = by_width[b2]
            bw = b2 * _B1
            sg = len(entries)
            mult = np.zeros((sg, bw), dtype=np.complex128)
            twc = np.zeros((sg, _B1, t_dim), dtype=np.complex128)
            for i, (s, lo) in enumerate(entries):
                hi = min(lo + bw, f)
                mult[i, :hi - lo] = mu[s, lo:hi]
                twc[i] = tw * np.exp(2j * np.pi * lo * m_axis / p)[None, :]
            groups.append(_Group(tuple(lo for _, lo in entries), b2,
                                 mult, twc))
        row_groups.append(groups)

    q_dim = -(-n_out // t_dim)
    e1 = np.exp(2j * np.pi * np.arange(_B1)[:, None]
                * np.arange(q_dim)[None, :] / _B1)
    # carrier q-part e^{2πi·o_s·q·T/P} = e^{2πi·o_s·q/128}, per group
    carr_qs = tuple(
        np.exp(2j * np.pi
               * np.asarray([lo for _, lo in by_width[b2]],
                            dtype=np.float64)[:, None]
               * np.arange(q_dim)[None, :] / _B1)
        for b2 in width_order)
    return mode, tuple(tuple(g) for g in row_groups), inv_perm, e1, \
        carr_qs, t_dim, q_dim


class _Parts(typing.NamedTuple):
    """A complex host constant on a device as (real, imag, real + imag)
    parts — the Karatsuba operands."""
    re: torch.Tensor
    im: torch.Tensor
    sum: torch.Tensor


class _DeviceGroup(typing.NamedTuple):
    index: torch.Tensor     # (Sg, b2·128) int64: each band's bins
    mult: _Parts            # (Sg, b2·128)
    twc: _Parts             # (Sg, 128, T)
    e2: _Parts | None       # (b2, T), None at b2 = 1
    carr_q: _Parts          # (Sg, Q, 1)


@functools.lru_cache(maxsize=32)
def _device_plan(plan_key: tuple, dtype: torch.dtype, device: torch.device):
    """The constants of ``band_plan(*plan_key)`` as tensors of ``dtype``
    on ``device``: (row sets of _DeviceGroup, e1 parts, inv_perm tensor or
    None where the order is already the caller's)."""
    _, row_groups, inv_perm, e1, carr_qs, t_dim, _ = band_plan(*plan_key)

    def parts(c):
        c = np.ascontiguousarray(c)
        return _Parts(*(torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype) for a in (c.real, c.imag,
                                                  c.real + c.imag)))

    rows = []
    for groups in row_groups:
        dev_groups = []
        for g, cq in zip(groups, carr_qs):
            bw = g.b2 * _B1
            index = (np.asarray(g.offsets, dtype=np.int64)[:, None]
                     + np.arange(bw, dtype=np.int64)[None, :])
            e2 = None
            if g.b2 > 1:
                e2 = parts(np.exp(2j * np.pi * np.arange(g.b2)[:, None]
                                  * np.arange(t_dim)[None, :] / t_dim))
            dev_groups.append(_DeviceGroup(
                torch.from_numpy(index).to(device), parts(g.mult),
                parts(g.twc), e2, parts(cq[:, :, None])))
        rows.append(tuple(dev_groups))
    identity = np.array_equal(inv_perm, np.arange(inv_perm.shape[0]))
    perm = None if identity else torch.from_numpy(inv_perm).to(device)
    return tuple(rows), parts(e1), perm


def _product(a: torch.Tensor, b: torch.Tensor, precision: str
             ) -> torch.Tensor:
    """``a @ b`` in the float32 tier ``precision`` (float64 as it is)."""
    if a.dtype != torch.float32:
        return _mm(a, b)
    if precision == "default":
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    return _mm(a, b, tf32=precision != "highest")


def _kara_einsum(contract, ar, ai, b: _Parts, precision):
    """Complex contraction in three real ones (Karatsuba; ``b.sum`` =
    br + bi precomputed).  ``contract(a, b_part, precision)`` is one real
    contraction of a data operand with a constant one."""
    p1 = contract(ar, b.re, precision)
    p2 = contract(ai, b.im, precision)
    p3 = contract(ar + ai, b.sum, precision)
    return p1 - p2, p3 - p1 - p2


def _over_blocks(y, e2, precision):
    """Σ_{b₂} y[…, b₂, k]·e2[b₂, m] → (…, k, m)  (``...bk,bm->...km``)."""
    return _product(y.mT, e2, precision)


def _over_lanes(h, e1, precision):
    """Σ_k h[…, k, m]·e1[k, q] → (…, q, m)  (``...km,kq->...qm``): the
    constant on the left, so the output comes out in (q, m) order and
    n = q·T + m is a plain reshape."""
    return _product(e1.mT, h, precision)


def _group_stage1(xr, xi, grp: _DeviceGroup, b2: int, precision):
    """Band windows → banded Y → twiddled H (…, Sg, 128, T) for one group."""
    gr = xr[..., grp.index]                       # (…, Sg, b2·128)
    gi = xi[..., grp.index]
    mr, mi = grp.mult.re, grp.mult.im
    yr = gr * mr - gi * mi
    yi = gr * mi + gi * mr
    if b2 == 1:
        gr2, gi2 = yr[..., None], yi[..., None]   # (…, Sg, 128, 1)
    else:
        lead = yr.shape[:-1]
        yr = yr.reshape(lead + (b2, _B1))
        yi = yi.reshape(lead + (b2, _B1))
        gr2, gi2 = _kara_einsum(_over_blocks, yr, yi, grp.e2, precision)
    twr, twi = grp.twc.re, grp.twc.im
    return gr2 * twr - gi2 * twi, gr2 * twi + gi2 * twr


def _rows_to_z(hr, hi, e1: _Parts, carr_q: _Parts, t_dim, q_dim, n_out,
               precision):
    """(…, S, 128, T) H rows → (…, S, n_out) z (split parts)."""
    zr, zi = _kara_einsum(_over_lanes, hr, hi, e1, precision)
    cqr, cqi = carr_q.re, carr_q.im                # (S, Q, 1)
    zr, zi = zr * cqr - zi * cqi, zr * cqi + zi * cqr
    lead = zr.shape[:-2]
    zr = zr.reshape(lead + (q_dim * t_dim,))[..., :n_out]
    zi = zi.reshape(lead + (q_dim * t_dim,))[..., :n_out]
    return zr, zi


def _run_plan(xh: torch.Tensor, plan_key: tuple, n_out: int, precision):
    """Evaluate every row set of a plan → list of (zr, zi) in caller order."""
    plan = band_plan(*plan_key)
    _, row_groups, _, _, _, t_dim, q_dim = plan
    rdt = torch.float64 if xh.dtype == torch.complex128 else torch.float32
    rows, e1, perm = _device_plan(plan_key, rdt, xh.device)
    xr, xi = xh.real.to(rdt), xh.imag.to(rdt)
    # The widest band window is 128-padded past F = P/2+1; zero-pad the
    # half-spectrum once so every window stays in range (the folded
    # multipliers are zero on the padding bins).
    f = xh.shape[-1]
    f_pad = max(max(g.offsets) + g.b2 * _B1 - f
                for gs in row_groups for g in gs)
    if f_pad > 0:
        xr = torch.nn.functional.pad(xr, (0, f_pad))
        xi = torch.nn.functional.pad(xi, (0, f_pad))

    def run_rows(groups, dev_groups):
        zrs, zis = [], []
        for g, dg in zip(groups, dev_groups):
            hr, hi = _group_stage1(xr, xi, dg, g.b2, precision)
            zr, zi = _rows_to_z(hr, hi, e1, dg.carr_q, t_dim, q_dim, n_out,
                                precision)
            zrs.append(zr)
            zis.append(zi)
        zr = zrs[0] if len(zrs) == 1 else torch.cat(zrs, dim=-2)
        zi = zis[0] if len(zis) == 1 else torch.cat(zis, dim=-2)
        if perm is not None:
            zr = torch.index_select(zr, -2, perm)
            zi = torch.index_select(zi, -2, perm)
        return zr, zi

    return [run_rows(gs, dgs) for gs, dgs in zip(row_groups, rows)]


def _combine(mode, zs):
    """Row-set results → coefficient tensor per the wavelet regime."""
    if mode == "analytic":
        return torch.complex(*zs[0])
    if mode == "real":
        return zs[0][0]
    return torch.complex(zs[0][0], zs[1][0])


def _plan_key(wavelet, scales_np, padded_n, sampling_rate, n_out,
              derivative=False):
    return (wavelet, tuple(float(s) for s in np.atleast_1d(scales_np)),
            int(padded_n), float(sampling_rate), int(n_out), _EPS,
            derivative)


def cwt_banded_coefficients(xh: torch.Tensor, n_out: int,
                            scales_np: np.ndarray,
                            wavelet: ContinuousWavelet, sampling_rate: float,
                            padded_n: int, precision: str = "highest"
                            ) -> torch.Tensor:
    """Coefficients (..., S, n_out) from the rfft half-spectrum ``xh``.

    ``xh``: (..., P/2+1) complex rfft of the padded real signal.  Output is
    complex (analytic/general ψ̂) or real (real-even ψ̂ — same convention as
    the half-spectrum path of :func:`~.cwt.cwt`).
    """
    key = _plan_key(wavelet, scales_np, padded_n, sampling_rate, n_out)
    zs = _run_plan(xh, key, int(n_out), precision)
    return _combine(band_plan(*key)[0], zs)


def cwt_banded_wd(xh: torch.Tensor, n_out: int, scales_np: np.ndarray,
                  wavelet: ContinuousWavelet, sampling_rate: float,
                  padded_n: int, precision: str = "highest"):
    """(W, ∂_t W) pair from one shared plan — the synchrosqueezing front end.

    The derivative rows use the multiplier iω·M, which shares M's band
    support, so band windows, twiddles and the stage-2 structure are
    reused.  W is complex even for a real-even ψ̂ (zero imaginary part).
    """
    key = _plan_key(wavelet, scales_np, padded_n, sampling_rate, n_out,
                    derivative=True)
    mode, row_groups = band_plan(*key)[:2]
    zs = _run_plan(xh, key, int(n_out), precision)
    base = len(row_groups) // 2
    w = _combine(mode, zs[:base])
    dw = _combine(mode, zs[base:])
    if mode == "real":
        cdt = torch.complex128 if w.dtype == torch.float64 \
            else torch.complex64
        w, dw = w.to(cdt), dw.to(cdt)
    return w, dw
