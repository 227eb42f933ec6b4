"""2D Continuous Wavelet Transform — batched FFT-multiplier formulation.

Counterpart of ``jwave_pro_tpu/ops/cwt2d.py``; same semantics and names.
The Antoine–Murenzi 2D CWT (the reference's CWT tier,
``jwave/transforms/ContinuousWaveletTransform.java``, is 1D-only):

    W(a, θ, b) = IFFT2[ X̂(k) · conj(a·ψ̂(a·r_{−θ}k)) ]

The whole (scale × angle) grid of multipliers is one float64 stack built
on the host (cached per wavelet, scales, angles, shape, rate and path) and
kept on each device per dtype; the image is FFT'd once and the per-(a, θ)
products inverse-transform as one batch, the plane axis cut into chunks
past 2²³ elements (each ≤ 2²²), the 1D tier's rule (``ops/cwt.py:
_scale_chunk``).  For real images and real-even ψ̂ (isotropic Mexican Hat)
the whole pipeline runs in the rfft2 half-plane with a real multiplier and
returns real coefficients.

Boundary convention: periodic (the DFT's own); pre-pad the image for
another extension.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np
import torch

from ..utils.device import as_input
from ..wavelets.continuous2d import ContinuousWavelet2D, MexicanHat2D
from .cwt import _host_grid, _on_device
from .fwt import _mm

__all__ = ["cwt2", "icwt2", "CWT2Result"]


class CWT2Result(typing.NamedTuple):
    """2D CWT output container (1D analog: ``ops/cwt.py:CWTResult``).

    ``coefficients``: shape ``(..., S, H, W)`` — or ``(..., S, A, H, W)``
    when an angle grid was swept; real when ψ̂ is real-even, else complex.
    """

    coefficients: torch.Tensor
    scales: torch.Tensor
    angles: torch.Tensor | None
    sampling_rate: float
    wavelet_name: str

    @property
    def magnitude(self):
        return torch.abs(self.coefficients)

    @property
    def phase(self):
        return torch.angle(self.coefficients)

    @property
    def scalogram(self):
        """Per-(scale[, angle]) energy Σ_b |W|² over the image plane."""
        return torch.sum(torch.abs(self.coefficients) ** 2, dim=(-2, -1))


@functools.lru_cache(maxsize=8)  # full (S·A, h, w) planes: kept small
def _multipliers2d(wavelet: ContinuousWavelet2D, scales: tuple,
                   angles: tuple | None, h: int, w: int,
                   sampling_rate: float, half: bool) -> np.ndarray:
    """Host-side float64 multiplier stack conj(a·ψ̂(a·r_{−θ}k)) on the DFT
    grid.

    With ``half=True`` (real image × real-even ψ̂) the stack is real, of
    shape ``(S·A, h, w//2+1)`` on the rfft2 half-plane — a real-even
    multiplier keeps the product Hermitian, so irfft2 closes the loop
    exactly; else the complex ``(S·A, h, w)`` plane.  ψ̂ is evaluated
    through the port's own formulas on CPU float64 tensors, whatever the
    input's dtype.
    """
    fs = sampling_rate
    ky = 2.0 * math.pi * np.fft.fftfreq(h) * fs
    kx = (2.0 * math.pi * np.fft.rfftfreq(w) * fs if half
          else 2.0 * math.pi * np.fft.fftfreq(w) * fs)
    gky = torch.from_numpy(ky[:, None])
    gkx = torch.from_numpy(kx[None, :])
    planes = []
    for a in scales:
        for th in ((0.0,) if angles is None else angles):
            m = np.conj(wavelet.psi_hat_scaled(gkx, gky, float(a),
                                               float(th)).numpy())
            planes.append(np.real(m) if half else m)
    return np.stack(planes)


def _plane_chunk(batch_elems: int, h: int, w: int, n_planes: int) -> int:
    """Planes per inverse FFT: all of them up to 2²³ elements of the
    (batch, planes, h, w) product, else the largest divisor of
    ``n_planes`` keeping a chunk ≤ 2²² elements (at least one plane)."""
    if batch_elems * h * w * n_planes > (1 << 23):
        target = max(1, (1 << 22) // max(batch_elems * h * w, 1))
        if target < n_planes:
            return max(c for c in range(1, min(target, n_planes) + 1)
                       if n_planes % c == 0)
    return n_planes


def cwt2(x: torch.Tensor, scales,
         wavelet: ContinuousWavelet2D | None = None, angles=None,
         sampling_rate: float = 1.0) -> CWT2Result:
    """2D CWT of an image (or batch of images) over static scale/angle grids.

    ``x``: ``(..., H, W)`` real or complex.  ``scales``: positive floats.
    ``angles``: optional orientation grid in radians — when given,
    coefficients gain an angle axis ``(..., S, A, H, W)``; for isotropic
    wavelets leave it ``None``.  Boundary is periodic.

    One image FFT + one batched multiplier product + one batched inverse
    FFT per chunk of planes; real-output path for real images under
    real-even ψ̂.  Integer input is transformed in float32; bfloat16 and
    float16 input in float32 too (the JAX package's real path raises for
    bfloat16: its rfft2 takes float32 or float64 only).
    """
    if wavelet is None:
        wavelet = MexicanHat2D()
    x = as_input(x)
    if not (x.is_floating_point() or x.is_complex()) or x.dtype in (
            torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    if x.ndim < 2:
        raise ValueError("cwt2 needs at least a (H, W) image")
    h, w = x.shape[-2], x.shape[-1]
    scales_np = _host_grid(scales)
    if np.any(scales_np <= 0):
        raise ValueError("Scales must be positive")
    angles_np = None if angles is None else _host_grid(angles)
    scales_t = tuple(float(a) for a in scales_np)
    angles_t = None if angles_np is None else tuple(float(t)
                                                    for t in angles_np)
    use_real = wavelet.real_even_hat and not x.is_complex()
    m_np = _multipliers2d(wavelet, scales_t, angles_t, h, w,
                          float(sampling_rate), use_real)
    f64 = x.dtype in (torch.float64, torch.complex128)
    cdtype = torch.complex128 if f64 else torch.complex64
    rdtype = torch.float64 if f64 else torch.float32

    n_planes = m_np.shape[0]
    if use_real:
        xf = torch.fft.rfft2(x, dim=(-2, -1))[..., None, :, :]
        # the real-even multiplier stays REAL: half the bytes of the stack
        mult = _on_device(m_np, x.device, rdtype)

        def run(m):
            return torch.fft.irfft2(xf * m, s=(h, w), dim=(-2, -1)).to(
                rdtype)
    else:
        xf = torch.fft.fft2(x.to(cdtype), dim=(-2, -1))[..., None, :, :]
        mult = _on_device(m_np, x.device, cdtype)

        def run(m):
            return torch.fft.ifft2(xf * m, dim=(-2, -1))

    lead = tuple(x.shape[:-2])
    chunk = _plane_chunk(math.prod(lead), h, w, n_planes)
    parts = [run(mult[i:i + chunk]) for i in range(0, n_planes, chunk)]
    coeff = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-3)

    if angles_t is None:
        coeff = coeff.reshape(lead + (len(scales_t), h, w))
        angles_arr = None
    else:
        coeff = coeff.reshape(lead + (len(scales_t), len(angles_t), h, w))
        angles_arr = torch.as_tensor(angles_np, device=x.device).to(rdtype)
    return CWT2Result(coeff, torch.as_tensor(scales_np, device=x.device).to(
        rdtype), angles_arr, sampling_rate, wavelet.name)


@functools.lru_cache(maxsize=8)
def _recon_filter2d(wavelet: ContinuousWavelet2D, scales: tuple,
                    angles: tuple | None, h: int, w: int,
                    sampling_rate: float):
    """Regularized 2D reconstruction filter G(k) — host float64, cached.

    2D analog of ``ops/cwt.py:_recon_filter``: the weighted plane sum
    R(b) = Σ_{a,θ} w_a/A · W(a,θ,b) is the image convolved with a kernel
    of spectrum H(k) = Σ w_a/A · conj(a·ψ̂(a·r_{−θ}k)); with w_a = Δln(a)/a
    the radial integrand is scale-invariant, so H is ~flat over the
    covered band, and G = conj(H₂)/(|H₂|² + ε²) (ε = 5% of the in-band
    peak) deconvolves it, with H₂(k) = H(k) + conj(H(−k)) the response on
    a real image (directional grids span θ ∈ [0, π), a k half-plane; the
    Hermitian half supplies the rest).
    """
    m = _multipliers2d(wavelet, scales, angles, h, w, sampling_rate,
                       half=False)
    scales_np = np.asarray(scales, dtype=np.float64)
    dln = (np.gradient(np.log(scales_np)) if scales_np.size > 1
           else np.ones(1))
    wts = dln / scales_np
    na = 1 if angles is None else len(angles)
    wfull = np.repeat(wts, na) / na
    hk = np.tensordot(wfull, m, axes=(0, 0))  # (h, w) complex
    h2 = hk + np.conj(np.roll(hk[::-1, ::-1], (1, 1), axis=(0, 1)))
    peak = float(np.max(np.abs(h2)))
    if peak < 1e-30:
        raise ValueError("wavelet/scale grid cannot be calibrated for icwt2")
    eps2 = (0.05 * peak) ** 2
    g = np.conj(h2) / (np.abs(h2) ** 2 + eps2)
    return g, wfull


def icwt2(result: CWT2Result, wavelet: ContinuousWavelet2D | None = None,
          scales=None, angles=None) -> torch.Tensor:
    """Approximate inverse 2D CWT (real-image reconstruction).

    Single-integral reconstruction with frequency compensation, the 2D
    analog of :func:`..cwt.icwt`: the Δln(a)/a-weighted plane sum is
    deconvolved by the grid's aggregate response (see
    :func:`_recon_filter2d`).  Assumes a real source image.  The grids are
    ``scales=``/``angles=`` or, by default, the result's own, moved to the
    host.  In-band components reconstruct to a few %; the image mean (DC)
    is not recoverable.
    """
    if wavelet is None:
        wavelet = MexicanHat2D()
    coeffs = as_input(result.coefficients)
    if not (coeffs.is_floating_point() or coeffs.is_complex()) or \
            coeffs.dtype in (torch.bfloat16, torch.float16):
        coeffs = coeffs.to(torch.float32)
    scales_np = _host_grid(result.scales if scales is None else scales)
    if angles is None and result.angles is not None:
        angles = result.angles
    angles_t = (None if angles is None else
                tuple(float(t) for t in _host_grid(angles)))
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    g, wfull = _recon_filter2d(
        wavelet, tuple(float(a) for a in scales_np), angles_t, h, w,
        float(result.sampling_rate))
    n_planes = wfull.shape[0]
    lead = coeffs.ndim - (4 if angles_t is not None else 3)
    flat = coeffs.reshape(coeffs.shape[:lead] + (n_planes, h * w))
    r = _mm(_on_device(wfull, coeffs.device, flat.dtype), flat)
    r = r.reshape(r.shape[:-1] + (h, w))
    # S(k) = FFT(2·Re r) = X̂·(H(k) + conj(H(−k))): the H₂ calibration
    rf = torch.fft.fft2(2.0 * (r.real if r.is_complex() else r),
                        dim=(-2, -1))
    x = torch.fft.ifft2(rf * _on_device(g, rf.device, rf.dtype),
                        dim=(-2, -1))
    return x.real
