"""Continuous Wavelet Transform — the FFT formulation, in PyTorch.

Counterpart of the ``cwt`` half of ``jwave_pro_tpu/ops/cwt.py``; same
semantics and names.  Reference: ``jwave/transforms/
ContinuousWaveletTransform.java``:

  * FFT path (``transformFFT``, ``:183-229``): pad to next pow-2, one signal
    FFT, per-scale multiply by conj(√a·ψ̂(a·ω)), inverse FFT, truncate.
  * Padding modes ZERO/SYMMETRIC/PERIODIC/CONSTANT (``padSignal``,
    ``:269-306``); fftfreq-style ω axis with sign flip past N/2
    (``createFrequencyAxis``, ``:450-459``).

The per-scale loop is one batched multiply: ψ̂ is evaluated on an
``(n_scales, n_freq)`` grid on the host in float64 (cached per wavelet,
scale grid, length and rate), the products inverse-FFT as one batch.
``method``: 'fft' takes the half-spectrum ``torch.fft.irfft`` path (real
input, static scales); 'fused' takes the multiply + inverse FFT kernel
(``kernels/cwt_cuda.py``: the CUDA kernel on a CUDA tensor, its plain
version on the CPU) for float32 input at the lengths it supports, else the
'fft' path; 'banded' the pruned-band path (``ops/cwt_banded.py``:
per-scale spectral bands and a factorized inverse DFT on cuBLAS products);
'auto' the fused path where the CUDA kernel runs and the answer needs no
gradient, else the 'fft' path (:func:`_auto_method`).  Complex input, and
scales given as a tensor that requires grad (the counterpart of the JAX
package's traced scales: ψ̂ is evaluated on the tensor's device), take the
full-FFT path; any other tensor of scales is static, as a concrete array
is in the JAX package.

The JAX package's 'auto' takes the banded path on a TPU
(``_banded_auto_ok``) and its kernel nowhere: that rule was tuned against
an XLA FFT at ~1 TFLOP/s effective, which cuFFT is not.  On the card one
``torch.fft.fft`` and one launch of the kernel replace the irfft path's
per-chunk products, inverse FFTs, ``cat`` and ``complex``, and write the
coefficients once; on the CPU the kernel's plain version is a matrix DFT,
so 'auto' keeps the irfft path there.

Also here: ``cwt_direct`` (the reference's time-domain correlation with
support clipping) and ``icwt`` (the frequency-compensated single-integral
inverse, its filter built on the host in float64).
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from ..utils.device import as_input, tracing
from ..utils.profiling import spanned
from ..utils.validation import next_power_of_two
from ..wavelets.continuous import ContinuousWavelet, MorletWavelet
from .fwt import _mm

__all__ = [
    "cwt", "cwt_direct", "icwt", "CWTResult", "generate_log_scales",
    "generate_linear_scales", "pad_signal",
]


class CWTResult(typing.NamedTuple):
    """CWT output container (parity with ``jwave/transforms/CWTResult.java``).

    ``coefficients``: complex (real for a real-output wavelet), shape
    ``(..., n_scales, N)``.
    """

    coefficients: torch.Tensor
    scales: torch.Tensor
    time_axis: torch.Tensor
    sampling_rate: float
    wavelet_name: str

    @property
    def magnitude(self):
        """|c| (CWTResult.java:94-107)."""
        return torch.abs(self.coefficients)

    @property
    def phase(self):
        """arg(c) (CWTResult.java:113-126)."""
        return torch.angle(self.coefficients)

    @property
    def real(self):
        c = self.coefficients
        return c.real if c.is_complex() else c

    @property
    def imag(self):
        c = self.coefficients
        return c.imag if c.is_complex() else torch.zeros_like(c)

    def scale_to_frequency(self, center_frequency: float):
        """f_a = fc·fs/a (CWTResult.java:185-197)."""
        return center_frequency * self.sampling_rate / self.scales

    @property
    def scalogram(self):
        """Per-scale energy Σ_t |c|² (CWTResult.java:272-287)."""
        return torch.sum(torch.abs(self.coefficients) ** 2, dim=-1)


def generate_log_scales(min_scale: float, max_scale: float, num: int):
    """Log-spaced scales (ContinuousWaveletTransform.java:355-380)."""
    _check_scales(min_scale, max_scale, num)
    return np.exp(np.linspace(math.log(min_scale), math.log(max_scale), num))


def generate_linear_scales(min_scale: float, max_scale: float, num: int):
    """Linearly spaced scales (ContinuousWaveletTransform.java:386-410)."""
    _check_scales(min_scale, max_scale, num)
    return np.linspace(min_scale, max_scale, num)


def _check_scales(lo, hi, num):
    if lo <= 0 or hi <= 0:
        raise ValueError("Scales must be positive")
    if lo >= hi:
        raise ValueError("minScale must be less than maxScale")
    if num < 2:
        raise ValueError("Need at least 2 scales")


def pad_signal(x: torch.Tensor, target: int, mode: str = "zero"
               ) -> torch.Tensor:
    """Right-pad the last axis to ``target`` samples.

    Modes 'zero' | 'symmetric' | 'periodic' | 'constant' match the
    reference's PaddingType (``ContinuousWaveletTransform.java:74-79,
    269-306``) including its symmetric-index convention
    ``mirror = 2·N − i − 2`` (out-of-range mirror indices stay zero).
    """
    x = as_input(x)
    n = x.shape[-1]
    pad = target - n
    if pad <= 0:
        return x[..., :target]
    mode = mode.lower()
    if mode == "zero":
        ext = x.new_zeros(x.shape[:-1] + (pad,))
    elif mode == "constant":
        ext = x[..., -1:].expand(x.shape[:-1] + (pad,))
    elif mode == "periodic":
        ext = x[..., torch.from_numpy(np.arange(n, target) % n).to(x.device)]
    elif mode == "symmetric":
        i = np.arange(n, target)
        mirror = 2 * n - i - 2
        valid = torch.from_numpy((mirror >= 0) & (mirror < n)).to(x.device)
        ext = x[..., torch.from_numpy(np.clip(mirror, 0, n - 1)).to(
            x.device)]
        ext = torch.where(valid, ext, 0.0).to(x.dtype)
    else:
        raise ValueError(f"unknown padding mode {mode!r}")
    return torch.cat([x, ext], dim=-1)


def _host_grid(values) -> np.ndarray:
    """A scale (or angle) grid as a 1D float64 host array; a tensor is
    detached and moved to the host."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().double().numpy()
    return np.atleast_1d(np.asarray(values, dtype=np.float64))


def _omega_axis(n: int, fs: float) -> np.ndarray:
    """ω_i = 2π·i·fs/n, flipped negative past n/2 (reference ``:450-459``)."""
    omega = 2.0 * math.pi * np.arange(n) * fs / n
    omega[np.arange(n) > n // 2] -= 2.0 * math.pi * fs
    return omega


def _psi_hat_grid(wavelet: ContinuousWavelet, omega: np.ndarray,
                  scales: np.ndarray) -> np.ndarray:
    """√a·ψ̂(a·ω) on the (S, F) grid, float64 on the host."""
    return wavelet.psi_hat_scaled(torch.from_numpy(omega[None, :]),
                                  torch.from_numpy(scales[:, None])).numpy()


@functools.lru_cache(maxsize=256)
@spanned("jwave.cwt.multipliers")
def _half_spectrum_multipliers(wavelet: ContinuousWavelet, scales: tuple,
                               padded_n: int, sampling_rate: float):
    """Host-side (A, B) multipliers on the rfft half grid — f64 numpy.

    The full-spectrum product W(ω) = X(ω)·M(ω) with M(ω) = conj(√a·ψ̂(aω))
    splits exactly into two Hermitian halves for real input x
    (X(−ω) = conj X(ω)):

        Re(c) = irfft(X⁺·A),   Im(c) = irfft(X⁺·B)

    with, for interior bins k = 1..P/2−1,

        A_k = (M(ω_k) + conj(M(−ω_k)))/2
        B_k = −i·(M(ω_k) − conj(M(−ω_k)))/2

    and DC/Nyquist (self-conjugate, appearing once in the full spectrum)
    A = Re(M), B = Im(M).  For real-even ψ̂ (Mexican Hat, even-order DOG)
    B ≡ 0 — detected here so :func:`cwt` skips the second irfft and returns
    *real* coefficients.
    """
    scales_np = np.asarray(scales, dtype=np.float64)
    omega = 2.0 * math.pi * np.arange(padded_n // 2 + 1) * sampling_rate \
        / padded_n
    m_pos = np.conj(_psi_hat_grid(wavelet, omega, scales_np))    # M(ω_k)
    psi_neg = _psi_hat_grid(wavelet, -omega, scales_np)          # √a·ψ̂(−aω_k)
    a = 0.5 * (m_pos + psi_neg)
    b = -0.5j * (m_pos - psi_neg)
    # DC bin and (P even) Nyquist bin appear once in the full spectrum
    a[:, 0] = np.real(m_pos[:, 0])
    b[:, 0] = np.imag(m_pos[:, 0])
    if padded_n % 2 == 0:
        a[:, -1] = np.real(m_pos[:, -1])
        b[:, -1] = np.imag(m_pos[:, -1])
    scale_mag = np.abs(a).max() + np.abs(b).max()
    b_is_zero = bool(np.abs(b).max() <= 1e-14 * max(scale_mag, 1e-300))
    a_is_zero = bool(np.abs(a).max() <= 1e-14 * max(scale_mag, 1e-300))
    return a, b, a_is_zero, b_is_zero


@functools.lru_cache(maxsize=256)
@spanned("jwave.cwt.multipliers")
def _full_spectrum_multipliers(wavelet: ContinuousWavelet, scales: tuple,
                               padded_n: int, sampling_rate: float):
    """Host-side full-spectrum multipliers + real-output flag.

    M[s, k] = conj(√a_s·ψ̂(a_s·ω_k)) on the full ω grid, complex128 — the
    fused multiply + inverse FFT's operand (``kernels/cwt_cuda.py``).
    ``is_real`` is True when M is Hermitian in k (real-even ψ̂ → real
    coefficients).
    """
    scales_np = np.asarray(scales, dtype=np.float64)
    m = np.conj(_psi_hat_grid(wavelet, _omega_axis(padded_n, sampling_rate),
                              scales_np))
    mirror = np.conj(np.roll(m[:, ::-1], 1, axis=-1))  # conj(M[-k])
    is_real = bool(np.max(np.abs(m - mirror)) <=
                   1e-12 * max(float(np.max(np.abs(m))), 1e-300))
    return m, is_real


_DEVICE_MULTIPLIERS: dict = {}


def _on_device(mult: np.ndarray, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """A host multiplier stack (one of the cached arrays above) as a tensor
    on ``device``, cached too: the entry holds the array, so its id stays
    its own while the entry lives.  At most 32 entries; none while torch
    traces (its tensors are fakes then)."""
    if tracing():
        return torch.from_numpy(mult).to(device=device, dtype=dtype)
    key = (id(mult), str(device), dtype)
    hit = _DEVICE_MULTIPLIERS.get(key)
    if hit is None:
        hit = _upload(key, mult, device, dtype)
    return hit[1]


@spanned("jwave.cwt.multipliers")
def _upload(key, mult: np.ndarray, device: torch.device,
            dtype: torch.dtype) -> tuple:
    """:func:`_on_device`'s miss: the stack copied to the device and
    cached under ``key``, the oldest entry dropped past 32."""
    if len(_DEVICE_MULTIPLIERS) >= 32:
        _DEVICE_MULTIPLIERS.pop(next(iter(_DEVICE_MULTIPLIERS)))
    hit = (mult, torch.from_numpy(mult).to(device=device, dtype=dtype))
    _DEVICE_MULTIPLIERS[key] = hit
    return hit


def _cwt_fused(xp: torch.Tensor, n: int, scales_np: np.ndarray,
               wavelet: ContinuousWavelet, sampling_rate: float):
    """The fused path: one ``torch.fft.fft`` of the signal, then the
    multiply + inverse FFT kernel.  Returns coefficients (..., S, n) —
    complex64, or float32 when ψ̂ is real-even — or None where the kernel
    does not run (decided before any launch)."""
    from ..kernels.cwt_cuda import cwt_fused_supported, cwt_ifft_fused

    padded_n = xp.shape[-1]
    n_scales = scales_np.shape[0]
    lead = tuple(xp.shape[:-1])
    b = math.prod(lead)
    if (xp.device.type not in ("cpu", "cuda")
            or not cwt_fused_supported(b, n_scales, padded_n)):
        return None
    m, is_real = _full_spectrum_multipliers(
        wavelet, tuple(float(s) for s in scales_np), padded_n,
        float(sampling_rate))
    xf = torch.fft.fft(xp.reshape(b, padded_n).to(torch.complex64), dim=-1)
    out = cwt_ifft_fused(xf, _on_device(m, xp.device, torch.complex64), n,
                         is_real)
    return out.reshape(lead + (n_scales, n))


def _auto_method(x: torch.Tensor, scales) -> str:
    """The path ``method='auto'`` takes for ``x`` (integer input already
    cast to float32) and ``scales``: 'fused' where the CUDA kernel gives
    the answer — a real CUDA tensor of float32, or of bfloat16 or float16
    (computed in float32), static scales, no gradient wanted of ``x`` (the
    kernel has no backward) and a padded length the kernel takes (a power
    of two in [64, 16384]) — else 'fft'."""
    from ..kernels.cwt_cuda import cwt_fused_supported

    if (not x.is_cuda
            or x.dtype not in (torch.float32, torch.bfloat16, torch.float16)
            or (isinstance(scales, torch.Tensor) and scales.requires_grad)
            or (torch.is_grad_enabled() and x.requires_grad)):
        return "fft"
    n_scales = (scales.numel() if isinstance(scales, torch.Tensor)
                else np.size(scales))
    fits = cwt_fused_supported(math.prod(x.shape[:-1]), n_scales,
                               next_power_of_two(x.shape[-1]))
    return "fused" if fits else "fft"


def _scale_chunk(batch_elems: int, padded_n: int, s_count: int) -> int:
    """Scale-axis chunk size that bounds the (batch, S, P) complex
    intermediate of the irfft path.

    Chunks only past 2²³ elements and keeps each chunk ≤ 2²² elements.
    Returns ``s_count`` (no chunking) or the largest divisor of ``s_count``
    under the target.
    """
    if batch_elems * padded_n * s_count > (1 << 23):
        target = max(1, (1 << 22) // max(batch_elems * padded_n, 1))
        if target < s_count:
            return max(c for c in range(1, min(target, s_count) + 1)
                       if s_count % c == 0)
    return s_count


def _half_irfft_chunked(xh, mult, padded_n, n, cdtype, rdtype, chunk):
    """irfft(xh · mult)[..., :n], the scale axis processed ``chunk`` rows
    at a time."""
    mult = _on_device(mult, xh.device, cdtype)
    parts = [torch.fft.irfft(xh * mult[i:i + chunk], n=padded_n,
                             dim=-1)[..., :n].to(rdtype)
             for i in range(0, mult.shape[0], chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def _cwt_full_fft(xp, n, scales_arr, wavelet, sampling_rate, cdtype):
    """Full-FFT path for complex input and scales that require grad: ψ̂ on
    the scales' device, one ``fft`` and one batched ``ifft``."""
    padded_n = xp.shape[-1]
    sig_fft = torch.fft.fft(xp.to(cdtype), dim=-1)           # (..., P)
    omega = torch.from_numpy(_omega_axis(padded_n, sampling_rate)).to(
        xp.device)[None, :]
    wav_fft = torch.conj(wavelet.psi_hat_scaled(
        omega, scales_arr[:, None])).to(cdtype)              # (S, P)
    prod = sig_fft[..., None, :] * wav_fft                   # (..., S, P)
    return torch.fft.ifft(prod, dim=-1)[..., :n]


@spanned("jwave.cwt.axes")
def _axis(values: np.ndarray, dtype: torch.dtype | None,
          device: torch.device) -> torch.Tensor:
    """A host axis of the result (its scales, its time axis) on
    ``device``: a copy from pageable memory, which waits for the card."""
    return torch.as_tensor(values, dtype=dtype, device=device)


def _resolve_precision(precision, low_default: bool) -> str:
    """The banded path's product tier from the user-facing ``precision``.

    ``None`` → 'highest' (IEEE float32) for float32 input, or 'high' (TF32)
    when ``low_default`` (bfloat16 input opted into the fast tier); the
    strings 'highest', 'high' and 'default' map to themselves.
    """
    if precision is None:
        return "high" if low_default else "highest"
    tier = str(precision).lower()
    if tier not in ("highest", "high", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    return tier


@spanned("jwave.cwt")
def cwt(x: torch.Tensor, scales, wavelet: ContinuousWavelet | None = None,
        sampling_rate: float = 1.0, padding: str = "zero",
        method: str = "auto", precision=None) -> CWTResult:
    """FFT-based CWT; coefficients ``(..., n_scales, N)`` on ``x``'s device.

    Equivalent of ``transformFFT`` (``ContinuousWaveletTransform.java:
    183-229``) in one batched op.  ``method``: 'fft' (the half-spectrum
    irfft path), 'fused' (the multiply + inverse FFT kernel for float32
    input at power-of-two padded lengths 64..16384, else the 'fft' path),
    'auto' ('fused' for a real float32, bfloat16 or float16 CUDA tensor at
    those lengths with static scales and no gradient wanted of ``x``, else
    'fft'; never 'banded', which the JAX package's TPU rule takes — see
    the module docstring), or 'banded' (the pruned-band path,
    ``ops/cwt_banded.py``;
    it needs a padded length that is a multiple of 128 and at least 512,
    and raises ``ValueError`` otherwise).  For wavelets with real-even ψ̂
    (Mexican Hat, even-order DOG) the coefficients are mathematically real
    and are returned as a real tensor.  ``scales``: a sequence, an array or
    a tensor; a tensor that requires grad takes the full-FFT path instead
    (complex coefficients, differentiable in the scales), as the JAX
    package's traced scales do.

    ``precision`` sets the banded path's float32 product tier:
    ``None``/'highest' IEEE float32, 'high' TF32 (a bfloat16 input selects
    it when ``precision`` is None; its coefficients are complex64 all the
    same), 'default' operands rounded to bfloat16 with float32 sums.  The
    other paths have no product to set.
    """
    if method not in ("auto", "banded", "fused", "fft"):
        raise ValueError(f"unknown CWT method {method!r}")
    if wavelet is None:
        wavelet = MorletWavelet()
    x = as_input(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    if method == "auto":
        method = _auto_method(x, scales)
    low_prec = x.dtype in (torch.bfloat16, torch.float16)
    if low_prec:
        x = x.to(torch.float32)       # spectra and FFTs have no bf16 form
    tier = _resolve_precision(precision, low_prec)
    n = x.shape[-1]
    padded_n = next_power_of_two(n)
    xp = pad_signal(x, padded_n, padding)
    cdtype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    rdtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    # scales that need a gradient take the full-FFT path, as traced scales
    # do in the JAX package; any other tensor is concrete and static
    traced_scales = isinstance(scales, torch.Tensor) and scales.requires_grad
    if isinstance(scales, torch.Tensor) and not traced_scales:
        scales = scales.detach().cpu().double().numpy()

    if traced_scales or x.is_complex():
        scales_arr = torch.atleast_1d(torch.as_tensor(
            scales, dtype=rdtype, device=x.device))
        coeff = _cwt_full_fft(xp, n, scales_arr, wavelet, sampling_rate,
                              cdtype)
    elif method == "banded":
        from .cwt_banded import banded_supported, cwt_banded_coefficients

        if not banded_supported(padded_n, n):
            raise ValueError(
                f"banded CWT needs a 128-divisible padded length ≥ 512, "
                f"got {padded_n}")
        scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
        scales_arr = torch.as_tensor(scales_np, dtype=rdtype,
                                     device=x.device)
        coeff = cwt_banded_coefficients(torch.fft.rfft(xp, dim=-1), n,
                                        scales_np, wavelet, sampling_rate,
                                        padded_n, precision=tier)
    else:
        scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
        coeff = None
        if method == "fused" and x.dtype == torch.float32:
            coeff = _cwt_fused(xp, n, scales_np, wavelet, sampling_rate)
        scales_arr = _axis(
            scales_np, torch.float32 if coeff is not None else rdtype,
            x.device)
        if coeff is None:
            a, b, a_zero, b_zero = _half_spectrum_multipliers(
                wavelet, tuple(float(s) for s in scales_np), padded_n,
                float(sampling_rate))
            xh = torch.fft.rfft(xp, dim=-1)[..., None, :]    # (..., 1, F)
            chunk = _scale_chunk(math.prod(xp.shape[:-1]), padded_n,
                                 len(scales_np))

            def half(mult):
                return _half_irfft_chunked(xh, mult, padded_n, n, cdtype,
                                           rdtype, chunk)

            if b_zero:
                coeff = half(a)          # mathematically real coefficients
            elif a_zero:
                coeff = (1j * half(b)).to(cdtype)
            else:
                coeff = torch.complex(half(a), half(b)).to(cdtype)

    time_axis = _axis(np.arange(n) * (1.0 / sampling_rate), None, x.device)
    return CWTResult(coeff, scales_arr, time_axis, sampling_rate,
                     wavelet.name)


def cwt_direct(x: torch.Tensor, scales,
               wavelet: ContinuousWavelet | None = None,
               sampling_rate: float = 1.0) -> CWTResult:
    """Direct (time-domain) CWT with support clipping.

    Parity with ``transform``/``computeCoefficient``
    (``ContinuousWaveletTransform.java:153-260``): for output time index b,
    ``c[a,b] = dt · Σ_{i∈support} x[i] · conj(ψ_{a}((i−b)·dt))`` where the
    support window is ``[b + ⌊s₀·a·fs⌋, b + ⌊s₁·a·fs⌋]`` clipped to the
    signal.  Per scale the (…, N, W) windows over a static offset range
    (an ``unfold`` of the zero-padded signal) and one product with the W
    taps (host float64, rounded to the input's precision); a real signal
    multiplies the taps' real and imaginary parts as two columns, so its
    windows stay real.
    Coefficients are complex64, or complex128 for float64 input.
    """
    if wavelet is None:
        wavelet = MorletWavelet()
    x = as_input(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    n = x.shape[-1]
    dt = 1.0 / sampling_rate
    scales_np = _host_grid(scales)
    s0, s1 = wavelet.effective_support()
    real = not x.is_complex()
    rdtype = torch.float64 if x.dtype in (torch.float64,
                                          torch.complex128) else torch.float32
    cdtype = torch.complex128 if rdtype == torch.float64 else torch.complex64

    rows = []
    for a in scales_np:
        # static offsets for this scale: j = i − b ∈ [off_lo, off_hi]
        off_lo = max(int(s0 * a * sampling_rate), -(n - 1))
        off_hi = min(int(s1 * a * sampling_rate), n - 1)
        offs = np.arange(off_lo, off_hi + 1)
        taps = np.conj(wavelet.psi_scaled(offs * dt, float(a)).numpy()) * dt
        # c[b] = Σ_j x[b+j]·taps[j], clipped at the edges (no wrap): zero
        # padding, like the reference's min/max index clamp
        pad_l, pad_r = max(0, -off_lo), max(0, off_hi)
        xpad = torch.nn.functional.pad(x, (pad_l, pad_r))
        start = off_lo + pad_l          # window b holds xpad[b + start + j]
        windows = xpad[..., start:].unfold(-1, offs.size, 1)[..., :n, :]
        if real:
            cols = torch.from_numpy(np.stack([taps.real, taps.imag], -1)).to(
                device=x.device, dtype=rdtype)              # (W, 2)
            out = _mm(windows.to(rdtype), cols)
            rows.append(torch.complex(out[..., 0], out[..., 1]))
        else:
            col = torch.from_numpy(taps[:, None]).to(device=x.device,
                                                     dtype=cdtype)
            rows.append(_mm(windows.to(cdtype), col)[..., 0])
    coeff = torch.stack(rows, dim=-2)                       # (…, S, N)
    time_axis = torch.as_tensor(np.arange(n) * dt, device=x.device)
    return CWTResult(coeff, torch.as_tensor(scales_np, device=x.device),
                     time_axis, sampling_rate, wavelet.name)


def _icwt_weights(scales: np.ndarray) -> np.ndarray:
    """Trapezoid weights in ln(a) over 1/√a (host-side, float64).

    With this library's FFT-path convention
    C(a,·) = IFFT[X · conj(√a·ψ̂(aω))], a flat reconstruction kernel needs
    w(a) = Δln(a)/√a:  Σ_a w(a)·√a·ψ̂(aω) = ∫ψ̂(aω) dln a, which is
    ω-independent by scale invariance of dln a.
    """
    log_s = np.log(scales)
    dln = np.gradient(log_s)
    return dln / np.sqrt(scales)


@functools.lru_cache(maxsize=256)
def _recon_filter(wavelet: ContinuousWavelet, scales: tuple, n: int,
                  sampling_rate: float):
    """Regularized reconstruction filter G(ω) — host numpy float64, cached
    per (wavelet, scale grid, length, fs).

    The weighted scale sum R(t) = Σ_a w_a·W(a,t) is x convolved with a
    kernel whose spectrum is H(ω) = Σ_a w_a·conj(√a·ψ̂(aω)); G is its
    Tikhonov-regularized inverse on the non-negative-frequency grid,
    conj(H)/(|H|² + ε²) with ε = 5% of the in-band peak — exact inside the
    scale-covered band, gracefully zero outside it (wavelets are zero-mean,
    so DC is never recoverable).  ψ̂ is evaluated through the port's own
    formulas on CPU float64 tensors.
    """
    scales_np = np.asarray(scales, dtype=np.float64)
    p = next_power_of_two(n)
    omega = torch.from_numpy(_omega_axis(p, sampling_rate))
    weights = _icwt_weights(scales_np)
    h = np.zeros(p, dtype=np.complex128)
    for a, w_a in zip(scales_np, weights):
        h += w_a * np.conj(wavelet.psi_hat_scaled(omega, float(a)).numpy())
    h_pos = h[:p // 2 + 1]
    peak = float(np.max(np.abs(h_pos)))
    if peak < 1e-30:
        raise ValueError("wavelet/scale grid cannot be calibrated for icwt")
    eps2 = (0.05 * peak) ** 2
    g = np.conj(h_pos) / (np.abs(h_pos) ** 2 + eps2)
    return g, p


def icwt(result: CWTResult, wavelet: ContinuousWavelet | None = None,
         scales=None) -> torch.Tensor:
    """Approximate inverse CWT (signal reconstruction from a scalogram).

    The reference has no inverse CWT; this is the single-integral
    reconstruction (Torrence & Compo 1998 eq. 11 generalized) with
    frequency compensation: the weighted scale sum R(t) = Σ_a Δln(a)/√a ·
    W(a,t) is deconvolved by the scale grid's aggregate response H(ω) (a
    cached host constant — see :func:`_recon_filter`), which makes the
    inverse self-consistent with this library's FFT-path conventions and
    works for all five continuous families, anti-symmetric odd-order DOG
    included.  The scale grid is ``scales=`` or, by default,
    ``result.scales`` moved to the host.

    Accuracy is that of the method (sub-1% relative L2 inside the
    scale-covered band for ≥ 16 scales/decade).  The signal mean (DC) is
    not recoverable from zero-mean wavelets.  Float16 and bfloat16
    coefficients are summed and transformed in float32 (the JAX package
    sums them in their own dtype; both return float32).
    """
    if wavelet is None:
        wavelet = MorletWavelet()
    coeffs = as_input(result.coefficients)
    if coeffs.dtype in (torch.float16, torch.bfloat16):
        # torch's FFTs take no bfloat16, and float16 only at powers of two
        # on CUDA
        coeffs = coeffs.float()
    scales_np = _host_grid(result.scales if scales is None else scales)
    n = coeffs.shape[-1]
    g, p = _recon_filter(wavelet, tuple(float(a) for a in scales_np), n,
                         float(result.sampling_rate))
    weights = torch.from_numpy(_icwt_weights(scales_np)).to(
        device=coeffs.device, dtype=coeffs.dtype)
    r = _mm(weights, coeffs)                             # Σ_s w_s·c[…, s, t]
    rf = torch.fft.fft(r, n=p, dim=-1)[..., :p // 2 + 1]
    x = torch.fft.irfft(rf * torch.from_numpy(g).to(device=rf.device,
                                                    dtype=rf.dtype),
                        n=p, dim=-1)
    return x[..., :n]
