"""Synchrosqueezed CWT — sharpened time-frequency analysis + mode extraction.

Counterpart of ``jwave_pro_tpu/ops/ssq.py``; same semantics and names.
Synchrosqueezing (Daubechies–Lu–Wu 2011) reassigns each CWT coefficient
W(a, t) to the frequency bin of its instantaneous frequency

    ω(a, t) = Im[ ∂_t W(a, t) / W(a, t) ]

(the reference's CWT tier, ``ContinuousWaveletTransform.java``, stops at
scalograms).

* ∂_t W is exact in the frequency domain: the CWT half-spectrum
  multipliers (A, B) (``ops/cwt.py:_half_spectrum_multipliers``) have the
  derivative counterparts (iω·A, iω·B), float64 host constants, so W and
  ∂_t W come from one shared rfft and four batched irffts.  That front end
  runs on every device: the JAX package takes its banded front end
  (``cwt_banded_wd``) on a TPU only, and on the H100 the irfft path beats
  the banded one (``PERF.md``), the rule ``cwt(method='auto')`` keeps.
  :func:`_reassign_planes` takes either front end's planes.
* The reassignment scatters with ``scatter_add_`` along the bin axis, the
  real and imaginary planes as two float tensors.  On CUDA the atomics
  sum each bin's contributions in no fixed order.
* Each reassigned summand carries the inverse-CWT weight Δln(a)/√a
  (``ops/cwt.py:_icwt_weights``), so ``Σ_bins Tx ≡ Σ_scales w_a·W`` and
  :func:`issq_cwt` inverts with the same calibrated deconvolution filter as
  :func:`..ops.cwt.icwt`, band-masked inversion included.

Use analytic wavelets (Morlet — the default — or Paul): real-ψ̂ families
(Mexican Hat, even DOG) have real W whose phase transform is degenerate.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from ..utils.device import as_input
from ..utils.validation import next_power_of_two
from ..wavelets.continuous import ContinuousWavelet, MorletWavelet
from .cwt import (
    _half_irfft_chunked, _half_spectrum_multipliers, _host_grid,
    _icwt_weights, _on_device, _recon_filter, _resolve_precision,
    _scale_chunk, pad_signal,
)

__all__ = ["ssq_cwt", "issq_cwt", "SSQResult"]


class SSQResult(typing.NamedTuple):
    """Synchrosqueezed CWT output.

    ``Tx``: complex, shape ``(..., n_freqs, N)`` — reassigned, inverse-
    weighted coefficients (``Σ_l Tx[l] = Σ_a Δln(a)/√a·W(a)``).
    ``Wx``: the underlying CWT coefficients ``(..., n_scales, N)``.
    ``ssq_freqs``: the log-spaced frequency bin centers in Hz.
    """

    Tx: torch.Tensor
    Wx: torch.Tensor
    ssq_freqs: torch.Tensor
    scales: torch.Tensor
    time_axis: torch.Tensor
    sampling_rate: float
    wavelet_name: str

    @property
    def magnitude(self):
        return torch.abs(self.Tx)

    @property
    def energy_profile(self):
        """Per-bin energy Σ_t |Tx|² (the sharpened 'scalogram')."""
        return torch.sum(torch.abs(self.Tx) ** 2, dim=-1)


@functools.lru_cache(maxsize=256)
def _ssq_multipliers(wavelet: ContinuousWavelet, scales: tuple,
                     padded_n: int, sampling_rate: float):
    """(A, B, iωA, iωB) half-spectrum stacks — host float64 numpy.

    Replacing M(ω) by iω·M(ω) maps (A_k, B_k) → (iω_k·A_k, iω_k·B_k) (both
    halves scale by the same self-conjugate-odd factor).  The Nyquist bin
    of the derivative pair is zeroed — iω there breaks the real-output
    symmetry irfft needs.
    """
    a, b, _, _ = _half_spectrum_multipliers(wavelet, scales, padded_n,
                                            sampling_rate)
    f = padded_n // 2 + 1
    omega = 2.0 * math.pi * np.arange(f) * sampling_rate / padded_n
    iw = 1j * omega[None, :]
    ad = iw * a
    bd = iw * b
    if padded_n % 2 == 0:
        ad[:, -1] = 0.0
        bd[:, -1] = 0.0
    return a, b, ad, bd


@functools.lru_cache(maxsize=256)
def _ssq_weights(scales: tuple) -> np.ndarray:
    """The inverse-CWT weights Δln(a)/√a of a scale grid (host float64)."""
    return _icwt_weights(np.asarray(scales, dtype=np.float64))


def _ssq_planes(xp, n, mults, rdtype, cdtype):
    """The irfft front end: padded signal → [Re W, Im W, Re ∂_t W,
    Im ∂_t W], each (..., S, N), through four chunked half-spectrum
    irffts (``ops/cwt.py:_scale_chunk``'s rule)."""
    padded_n = xp.shape[-1]
    xh = torch.fft.rfft(xp, dim=-1)[..., None, :]          # (..., 1, F)
    chunk = _scale_chunk(math.prod(xp.shape[:-1]), padded_n,
                         mults[0].shape[0])
    return [_half_irfft_chunked(xh, m, padded_n, n, cdtype, rdtype, chunk)
            for m in mults]


def _bins(w_re, w_im, d_re, d_im, log_lo, dlog, n_freqs, gamma, rdtype,
          group=None):
    """Each coefficient's bin: (idx, valid, idx_f).

    ``idx_f`` is the fractional log-frequency bin of the instantaneous
    frequency ω = Im[∂_t W / W]; ``idx`` its nearest bin (``torch.round``:
    half to even, as ``jnp.round``), clipped into range; ``valid`` marks
    the coefficients that are reassigned: above the threshold (``gamma``,
    or 1e-6 of each signal's peak |W|), with a positive frequency inside
    the bin grid.  With a process ``group`` the planes hold one shard of
    the scales and the peak is the MAX over the group's shards
    (``lax.pmax`` in the JAX package's ``axis_name``)."""
    mag2 = w_re * w_re + w_im * w_im
    tiny = torch.finfo(rdtype).tiny
    if gamma is None:
        peak = torch.amax(mag2, dim=(-2, -1), keepdim=True)
        if group is not None:
            from ..parallel.sharded import all_reduce_max
            peak = all_reduce_max(peak, group)
        thresh2 = (1e-6 ** 2) * peak
    else:
        thresh2 = torch.tensor(float(gamma) ** 2, dtype=rdtype,
                               device=mag2.device)
    # phase transform: ω_inst = Im[∂_t W / W] (rad/s) → Hz
    inst_f = (d_im * w_re - d_re * w_im) / (
        2.0 * math.pi * torch.clamp_min(mag2, tiny))
    valid = (mag2 > thresh2) & (inst_f > 0)
    safe_f = torch.clamp_min(inst_f, tiny)
    idx_f = (torch.log(safe_f) - log_lo) / dlog
    idx = torch.round(idx_f).to(torch.int64)
    valid &= (idx >= 0) & (idx < n_freqs)
    return torch.clamp(idx, 0, n_freqs - 1), valid, idx_f


def _reassign_planes(w_re, w_im, d_re, d_im, weights, log_lo, dlog, n_freqs,
                     gamma, rdtype, cdtype, group=None):
    """(W, ∂_t W) quadrature planes → (Tx, W) — the reassignment scatter.

    ``weights``: the (S,) host float64 weights (rounded to ``rdtype`` on
    the planes' device).  Each valid coefficient goes, weighted, to its
    bin (:func:`_bins`).  With a process ``group`` (each rank one shard of
    the scales) the partial Tx are summed over it in one SUM all-reduce,
    reassignment being additive over scales (``lax.psum``)."""
    idx, valid, _ = _bins(w_re, w_im, d_re, d_im, log_lo, dlog, n_freqs,
                          gamma, rdtype, group)
    wts = _on_device(weights, w_re.device, rdtype)[:, None]
    shape = w_re.shape[:-2] + (n_freqs, w_re.shape[-1])
    tx_re, tx_im = (
        torch.zeros(shape, dtype=rdtype, device=w_re.device).scatter_add_(
            -2, idx, torch.where(valid, part, 0.0) * wts)
        for part in (w_re, w_im))
    tx = torch.complex(tx_re, tx_im)
    if group is not None:
        from ..parallel.sharded import all_reduce_sum
        tx = all_reduce_sum(tx, group)
    return tx, torch.complex(w_re, w_im)


def _static_scales(scales) -> np.ndarray:
    if isinstance(scales, torch.Tensor) and scales.requires_grad:
        raise ValueError(
            "ssq_cwt needs a STATIC scale grid (multipliers and bin edges "
            "are host-precomputed): pass scales that need no gradient")
    return _host_grid(scales)


def ssq_cwt(x: torch.Tensor, scales,
            wavelet: ContinuousWavelet | None = None,
            sampling_rate: float = 1.0, n_freqs: int | None = None,
            freq_range: tuple[float, float] | None = None,
            padding: str = "zero", gamma: float | None = None,
            precision=None) -> SSQResult:
    """Synchrosqueezed CWT of a real signal over a static scale grid.

    ``x``: real ``(batch…, N)``.  ``scales``: positive floats (physical
    units; bin defaults assume f = fc/a).  ``n_freqs``: number of
    log-spaced output frequency bins (default ``len(scales)``).
    ``freq_range``: (f_min, f_max) in Hz for the bin grid — defaults to
    the scale grid's own band [fc/a_max, fc/a_min].  ``gamma``: magnitude
    threshold below which coefficients are dropped instead of reassigned
    (default 1e-6 of the per-signal peak |W|).

    ``precision`` is validated as the JAX package's (None, 'highest',
    'high', 'default'); it sets the tier of that package's banded front
    end, which runs on a TPU only, and has no effect here, where the
    irfft front end runs on every device.
    """
    if wavelet is None:
        wavelet = MorletWavelet()
    x = as_input(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    low_prec = x.dtype in (torch.bfloat16, torch.float16)
    if low_prec:
        x = x.to(torch.float32)
    _resolve_precision(precision, low_prec)
    if x.is_complex():
        raise ValueError("ssq_cwt expects a real signal")
    n = x.shape[-1]
    padded_n = next_power_of_two(n)
    scales_np = _static_scales(scales)
    if np.any(scales_np <= 0):
        raise ValueError("Scales must be positive")
    s_count = scales_np.shape[0]
    if n_freqs is None:
        n_freqs = s_count
    if n_freqs < 2:
        raise ValueError("need at least 2 frequency bins")

    fc = float(wavelet.center_frequency)
    if freq_range is None:
        f_lo = fc / float(scales_np.max())
        f_hi = fc / float(scales_np.min())
    else:
        f_lo, f_hi = float(freq_range[0]), float(freq_range[1])
    if not (0 < f_lo < f_hi):
        raise ValueError("freq_range must satisfy 0 < f_min < f_max")
    log_lo, log_hi = math.log(f_lo), math.log(f_hi)
    dlog = (log_hi - log_lo) / (n_freqs - 1)

    rdtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    cdtype = (torch.complex128 if x.dtype == torch.float64
              else torch.complex64)
    xp = pad_signal(x, padded_n, padding)
    scales_t = tuple(float(s) for s in scales_np)
    mults = _ssq_multipliers(wavelet, scales_t, padded_n,
                             float(sampling_rate))
    tx, w_coef = _reassign_planes(*_ssq_planes(xp, n, mults, rdtype,
                                               cdtype),
                                  _ssq_weights(scales_t), log_lo, dlog,
                                  n_freqs, gamma, rdtype, cdtype)

    freqs = np.exp(log_lo + dlog * np.arange(n_freqs))
    dt = 1.0 / sampling_rate
    return SSQResult(tx, w_coef,
                     torch.as_tensor(freqs, device=x.device).to(rdtype),
                     torch.as_tensor(scales_np, device=x.device).to(rdtype),
                     torch.as_tensor(np.arange(n) * dt, device=x.device),
                     sampling_rate, wavelet.name)


def issq_cwt(result: SSQResult, wavelet: ContinuousWavelet | None = None,
             freq_range: tuple[float, float] | None = None,
             scales=None) -> torch.Tensor:
    """Invert a synchrosqueezed CWT — optionally over a frequency band.

    Because each Tx entry carries its inverse-CWT weight, ``Σ_l Tx[l, t]``
    equals :func:`..ops.cwt.icwt`'s weighted scale sum, and the same
    cached deconvolution filter (``ops/cwt.py:_recon_filter``) closes the
    loop.  ``freq_range=(f_lo, f_hi)`` restricts the sum to bins inside
    the band — reconstructing one component of a multicomponent signal
    from its ridge.  The scale grid is ``scales=`` or, by default,
    ``result.scales`` moved to the host; the bin frequencies likewise.
    """
    if wavelet is None:
        wavelet = MorletWavelet()
    scales_np = _static_scales(result.scales if scales is None else scales)
    tx = as_input(result.Tx)
    n = tx.shape[-1]
    if freq_range is not None:
        freqs = _host_grid(result.ssq_freqs)
        mask = (freqs >= float(freq_range[0])) & \
               (freqs <= float(freq_range[1]))
        if not mask.any():
            raise ValueError("freq_range selects no bins")
        keep = torch.from_numpy(np.nonzero(mask)[0]).to(tx.device)
        r = torch.sum(tx.index_select(-2, keep), dim=-2)
    else:
        r = torch.sum(tx, dim=-2)
    g, p = _recon_filter(wavelet, tuple(float(a) for a in scales_np), n,
                         float(result.sampling_rate))
    rf = torch.fft.fft(r, n=p, dim=-1)[..., :p // 2 + 1]
    x = torch.fft.irfft(rf * _on_device(g, rf.device, rf.dtype), n=p, dim=-1)
    return x[..., :n]
