"""Maximal Overlap Discrete Wavelet Transform (MODWT) in PyTorch.

Counterpart of ``jwave_pro_tpu/ops/modwt.py``; same semantics and names.
Reference semantics (``jwave/transforms/MODWTTransform.java``):
  * base filters = wavelet's decomposition banks, L2-normalized then ÷ √2
    (``initializeFilterCache``, ``:452-484``);
  * level-j filter = base filter upsampled with ``2^(j-1) - 1`` zeros between
    taps (``upsample``, ``:618-630``);
  * forward: ``W_j = x ⊛ h̃_j``, ``V_j = x ⊛ g̃_j`` with circular convolution
    ``y[n] = Σ_m x[(n-m) mod N] f[m]`` (``circularConvolve``, ``:677-690``);
  * inverse: adjoint convolution ``y[n] = Σ_m x[(n+m) mod N] f[m]``, summed
    over the two branches (``inverseMODWT``, ``:337-375``).

The upsampled filter is never materialized: circular convolution with it is
a dilated (à-trous) convolution with the M-tap base filter, computed as a sum
of rolled copies (2·M multiply-adds per sample and level).  The direct path
stays rolls and multiply-adds on purpose: a ``conv1d`` would run through
cuDNN in TF32 by default on the card and lose the 1e-5 parity bound.

On a CUDA float32/bfloat16 tensor, ``method='auto'`` sends the shapes the
kernel supports to the fused CUDA kernels (``kernels/modwt_cuda.py``);
float64 and unsupported shapes take the plain path below.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import as_input
from ..utils.profiling import spanned
from ..wavelets.base import DiscreteWavelet

__all__ = [
    "modwt", "imodwt", "modwt_mra", "modwt_base_filters",
    "MAX_DECOMPOSITION_LEVEL", "circular_convolve", "circular_convolve_adjoint",
]

#: Maximum supported decomposition level (MODWTTransform.java:107-111).
MAX_DECOMPOSITION_LEVEL = 13

#: N·M product above which the reference's AUTO mode picks FFT convolution
#: (MODWTTransform.java:118-144); see :func:`_use_fft`.
FFT_CONVOLUTION_THRESHOLD = 4096


def modwt_base_filters(wavelet: DiscreteWavelet):
    """(g̃, h̃): unit-L2-normalized decomposition banks divided by √2.

    Mirrors ``MODWTTransform.initializeFilterCache`` (``:452-484``).
    Returns numpy float64 arrays (host-side constants).
    """
    def norm(f):
        f = np.asarray(f, dtype=np.float64)
        e = math.sqrt(float(np.sum(f * f)))
        if e > 1e-12:
            f = f / e
        return f / math.sqrt(2.0)

    return norm(wavelet.dec_lo), norm(wavelet.dec_hi)


def taps_as(f: np.ndarray, dtype: torch.dtype) -> list[float]:
    """Filter taps rounded to ``dtype`` and returned as Python floats.

    Each float is exact in ``dtype``, so ``tap * tensor`` multiplies by the
    same value the JAX package's ``jnp.asarray(f, dtype)`` holds.
    """
    return torch.as_tensor(f, dtype=dtype).tolist()


def _conv_channels(x: torch.Tensor, kernels, dilation: int,
                   adjoint: bool) -> torch.Tensor:
    """Circular (adjoint-)convolution of ``x`` with each kernel, dilated.

    ``y_c[n] = Σ_k x[(n ∓ k·d) mod N] f_c[k]`` — a sum of circularly rolled
    copies, sharing each roll across output channels.  ``kernels`` are
    sequences of Python floats.  Returns ``(..., C, N)``.
    """
    m = len(kernels[0])
    sign = -1 if adjoint else 1
    outs = [None] * len(kernels)
    for k in range(m):
        r = torch.roll(x, sign * k * dilation, dims=-1) if k else x
        for c, f in enumerate(kernels):
            term = f[k] * r
            outs[c] = term if outs[c] is None else outs[c] + term
    return torch.stack(outs, dim=-2)


def _wrapped_filter_fft(f: np.ndarray, dilation: int, n: int):
    """rFFT of the level filter wrapped to length ``n`` (host-side constant).

    The mod-N accumulate of ``wrapFilterToSignalLength``
    (``MODWTTransform.java:729-741``), done on the upsampled filter without
    materializing it: index of tap k is ``(k·d) mod n``.
    """
    w = np.zeros(n, dtype=np.float64)
    idx = (np.arange(f.shape[0]) * dilation) % n
    np.add.at(w, idx, f)
    return np.fft.rfft(w)


@functools.lru_cache(maxsize=128)
def _composite_fft_multipliers(wavelet: DiscreteWavelet, level: int, n: int):
    """The whole à-trous cascade as one (level+1, F) multiplier stack.

    Circular convolutions compose exactly on the DFT grid, so
    ``W_j = (Π_{i<j} G_i)·H_j·X`` and ``V_J = (Π G_i)·X``: one rfft and one
    batched irfft instead of 3·J FFT passes.  Host-side complex128, cached
    per ``(wavelet, level, n)``; row order matches :func:`modwt`.
    """
    g, h = modwt_base_filters(wavelet)
    rows = []
    cum = np.ones(n // 2 + 1, dtype=np.complex128)
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        rows.append(cum * _wrapped_filter_fft(h, d, n))
        cum = cum * _wrapped_filter_fft(g, d, n)
    rows.append(cum)
    return np.stack(rows)


def _spectral(mult: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host complex128 constant cast to ``like``'s complex dtype and device."""
    return torch.from_numpy(mult).to(device=like.device, dtype=like.dtype)


def _composite_shape(mult: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """Reshape the (R, F) stack to broadcast over leading batch dims."""
    r, f = mult.shape
    return mult.reshape((r,) + (1,) * batch_ndim + (f,))


def _use_fft(method: str, n: int, m_base: int, dilation: int) -> bool:
    if method == "fft":
        return True
    if method == "direct":
        return False
    if method == "auto":
        # Cost-based: the dilated direct path is O(N·M_base); FFT is
        # O(N log N).  Direct wins unless the base filter is very long.
        return m_base > 4 * max(math.log2(max(n, 2)), 1.0)
    if method == "auto_reference":
        # The reference's heuristic on the *upsampled* length
        # (MODWTTransform.java:640-664).
        m_up = (m_base - 1) * dilation + 1
        return n * m_up > FFT_CONVOLUTION_THRESHOLD
    raise ValueError(f"unknown convolution method {method!r}")


def _level_conv(v, g, h, j, method, adjoint=False, w=None):
    """One MODWT level: returns (V-branch, W-branch) results."""
    n = v.shape[-1]
    d = 1 << (j - 1)
    if _use_fft(method, n, g.shape[0], d):
        gf = _wrapped_filter_fft(g, d, n)
        hf = _wrapped_filter_fft(h, d, n)
        if adjoint:
            gf, hf = np.conj(gf), np.conj(hf)
        vf = torch.fft.rfft(v)
        wf = vf if w is None else torch.fft.rfft(w)
        out_v = torch.fft.irfft(vf * _spectral(gf, vf), n=n).to(v.dtype)
        out_w = torch.fft.irfft(wf * _spectral(hf, wf), n=n).to(v.dtype)
        return out_v, out_w
    gk = taps_as(g, v.dtype)
    hk = taps_as(h, v.dtype)
    if w is None:
        out = _conv_channels(v, (gk, hk), d, adjoint)
        return out[..., 0, :], out[..., 1, :]
    out_v = _conv_channels(v, (gk,), d, adjoint)[..., 0, :]
    out_w = _conv_channels(w, (hk,), d, adjoint)[..., 0, :]
    return out_v, out_w


def _combined_adjoint(v, w, g, h, d, dim: int = -1):
    """Σ_k roll(g[k]·v + h[k]·w, −k·d) along ``dim`` — one inverse MODWT
    level (the 2D inverse also runs it along the rows, ``dim=-2``).

    Only the SUM of the two adjoint branches is ever needed, so combining
    before rolling does one roll per tap instead of two.  ``g``/``h`` are
    sequences of Python floats.
    """
    acc = None
    for k in range(len(g)):
        t = g[k] * v + h[k] * w
        if k:
            t = torch.roll(t, -k * d, dims=dim)
        acc = t if acc is None else acc + t
    return acc


def _check_level(n: int, level: int) -> None:
    if level < 1:
        raise ValueError(f"decomposition level must be ≥ 1, got {level}")
    if level > MAX_DECOMPOSITION_LEVEL:
        raise ValueError(
            f"maximum supported decomposition level is "
            f"{MAX_DECOMPOSITION_LEVEL}, requested {level} "
            "[parity: MODWTTransform.java:107-111]"
        )
    theo = n.bit_length() - 1 if n > 0 else 0
    if level > theo:
        raise ValueError(
            f"decomposition level {level} exceeds theoretical limit {theo} "
            f"for signal length {n} [parity: MODWTTransform.java:279-284]"
        )


def _try_kernel(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                inverse: bool = False):
    """Dispatch to the fused CUDA kernel when device, dtype and shape allow.

    The decision is made from device, dtype and shape before any launch:
    float64 and shapes :func:`kernel_supported` rejects return None (the
    plain path), as ``_try_pallas`` sends them to XLA.  Once decided, the
    call goes straight to the autograd pair, whose operator checks its
    operands again as any caller's.
    """
    from ..kernels import modwt_cuda as kc
    from ..kernels._launch import DTYPE_CODES

    # inverse: (L+1, B, N) batched or (L+1, N); forward: (B, N) or (N,)
    if (not x.is_cuda or x.dtype not in DTYPE_CODES
            or x.ndim not in ((2, 3) if inverse else (1, 2))):
        return None
    # a differentiable call also needs the other direction's kernel, which
    # is its backward
    kinds = ("inv", "fwd") if inverse else ("fwd", "inv")
    if not all(kc.kernel_supported(x.shape[-1], level, wavelet.length, kind)
               for kind in kinds[:1 + x.requires_grad]):
        return None
    return (kc.ImodwtFused.apply(x, wavelet) if inverse
            else kc.ModwtFused.apply(x, wavelet, level))


def _as_signal(x) -> torch.Tensor:
    x = as_input(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    return x


@spanned("jwave.modwt")
def modwt(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
          method: str = "auto") -> torch.Tensor:
    """Forward MODWT on the last axis; works for arbitrary (non-pow2) N.

    Returns shape ``(level+1, ..., N)``: rows 0..level-1 are detail
    coefficients W_1..W_J, row level is the approximation V_J — the layout of
    ``MODWTTransform.forwardMODWT`` (``MODWTTransform.java:256-306``).  The
    result lies on ``x``'s device.

    ``method``: 'direct' (dilated à-trous conv), 'fft', 'pallas' (the fused
    CUDA kernel; the JAX package's spelling — raises where the kernel cannot
    run), 'auto' (fused kernel for CUDA f32/bf16 input when the shape allows,
    else a cost model between direct/fft), or 'auto_reference' (the
    reference's N·M>4096 rule, ``MODWTTransform.java:640-664``).
    """
    x = _as_signal(x)
    _check_level(x.shape[-1], level)
    if method in ("auto", "pallas"):
        out = _try_kernel(x, wavelet, level)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused kernel unavailable for shape {tuple(x.shape)} dtype "
                f"{x.dtype} on device {x.device}")
        method = "auto"
    g, h = modwt_base_filters(wavelet)
    n = x.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        # composite spectral cascade: one rfft + one batched irfft
        xf = torch.fft.rfft(x)
        mult = _composite_shape(_spectral(
            _composite_fft_multipliers(wavelet, level, n), xf), x.ndim - 1)
        return torch.fft.irfft(xf[None] * mult, n=n).to(x.dtype)
    rows = []
    v = x
    for j in range(1, level + 1):
        v_next, w_next = _level_conv(v, g, h, j, method)
        rows.append(w_next)
        v = v_next
    rows.append(v)
    return torch.stack(rows, dim=0)


@spanned("jwave.imodwt")
def imodwt(coeffs: torch.Tensor, wavelet: DiscreteWavelet,
           method: str = "auto") -> torch.Tensor:
    """Inverse MODWT: reconstruct the signal from ``(level+1, ..., N)`` coeffs.

    Mirrors ``MODWTTransform.inverseMODWT`` (``:337-375``): top-down
    ``V_{j-1} = adjoint(V_j, g̃_j) + adjoint(W_j, h̃_j)``.
    """
    coeffs = as_input(coeffs)
    level = coeffs.shape[0] - 1
    if level < 1:
        raise ValueError("need at least level 1 (rows W_1 and V_1)")
    if method in ("auto", "pallas"):
        out = _try_kernel(coeffs, wavelet, level, inverse=True)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused kernel unavailable for shape {tuple(coeffs.shape)}")
        method = "auto"
    g, h = modwt_base_filters(wavelet)
    v = coeffs[level]
    n = coeffs.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        # adjoint composite cascade: the per-level conj multipliers compose
        # to the conj of the forward stack — (level+1) rffts, ONE irfft
        cf = torch.fft.rfft(coeffs)
        mult = _composite_shape(_spectral(np.conj(
            _composite_fft_multipliers(wavelet, level, n)), cf),
            coeffs.ndim - 2)
        acc = torch.sum(cf * mult, dim=0)
        return torch.fft.irfft(acc, n=n).to(coeffs.dtype)
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        if _use_fft(method, n, g.shape[0], d):
            va, wa = _level_conv(v, g, h, j, method, adjoint=True,
                                 w=coeffs[j - 1])
            v = va + wa
        else:
            v = _combined_adjoint(v, coeffs[j - 1], taps_as(g, v.dtype),
                                  taps_as(h, v.dtype), d)
    return v


def modwt_mra(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
              method: str = "auto") -> torch.Tensor:
    """Multiresolution analysis: additive detail/smooth components.

    Returns ``(level+1, ..., N)``: rows 0..level-1 are details D_j, row level
    is the smooth S_J, with ``x = Σ D_j + S_J`` (the reference demonstrates
    this decomposition in ``examples/MODWTExample.java``).
    """
    c = modwt(x, wavelet, level, method)
    comps = []
    for j in range(level + 1):
        cj = torch.zeros_like(c)
        cj[j] = c[j]
        comps.append(imodwt(cj, wavelet, method))
    return torch.stack(comps, dim=0)


def circular_convolve(x, f, method: str = "direct"):
    """Public helper: ``y[n] = Σ_m x[(n-m) mod N] f[m]`` (non-dilated)."""
    x = as_input(x)
    return _conv_channels(x, (taps_as(np.asarray(f), x.dtype),), 1,
                          adjoint=False)[..., 0, :]


def circular_convolve_adjoint(x, f, method: str = "direct"):
    """Public helper: ``y[n] = Σ_m x[(n+m) mod N] f[m]`` (non-dilated)."""
    x = as_input(x)
    return _conv_channels(x, (taps_as(np.asarray(f), x.dtype),), 1,
                          adjoint=True)[..., 0, :]
