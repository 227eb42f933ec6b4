"""2D/3D separable MODWT (undecimated wavelet transform for images and
volumes) in PyTorch.

Counterpart of ``jwave_pro_tpu/ops/modwt2d.py``; same semantics and names.
Per level j the à-trous filter pair runs along the columns (last axis), then
along the rows (then along the depth, for 3D), producing full-resolution
detail bands and an approximation that feeds the next level.

Band-letter convention: letters read in the order of the printed shape,
(row, col) for 2D and (depth, row, col) for 3D, with L applying the scaling
filter g and H the wavelet filter h along that axis.  ``modwt2`` returns
``(3·level+1, ..., R, C)``: rows ``3(j−1) .. 3(j−1)+2`` are (LH_j, HL_j,
HH_j) — (g@rows·h@cols, h@rows·g@cols, h@rows·h@cols) — and the last row is
LL_J.  ``modwt3`` returns ``(7·level+1, ..., D, R, C)``: rows
``7(j−1) .. 7(j−1)+6`` are the detail octants in increasing binary order of
the letter string (LLH, LHL, LHH, HLL, HLH, HHL, HHH), and the last row is
LLL_J.  Perfect reconstruction follows per axis from the 1D identity
``Conv_gᵀConv_g + Conv_hᵀConv_h = I`` (the √2-normalized MODWT filter bank).

The JAX package transposes the row axis to the lane axis around every roll
(a TPU layout matter); here the row pass makes no transposed copy: the
forward rolls a ``movedim`` view, the inverse rolls ``dims=-2``.  On a
CUDA float32/bfloat16 tensor, ``method='auto'`` sends the shapes the kernels
support to the fused CUDA kernels (``kernels/modwt2_cuda.py``,
``kernels/modwt3_cuda.py``); float64, tensors that require a gradient (the
2D and 3D kernels have no backward) and unsupported shapes take the plain
path below.
"""
from __future__ import annotations

import torch

from ..utils.device import as_input
from ..wavelets.base import DiscreteWavelet
from .modwt import (
    MAX_DECOMPOSITION_LEVEL, _as_signal, _combined_adjoint, _conv_channels,
    modwt_base_filters, taps_as,
)

__all__ = ["modwt2", "imodwt2", "modwt2_mra", "modwt3", "imodwt3",
           "modwt3_mra"]


def _conv_axis_pair(x: torch.Tensor, g, h, d: int, axis: int,
                    adjoint: bool = False):
    """(x⋆g, x⋆h) along ``axis``, sharing the rolled copies."""
    out = _conv_channels(x.movedim(axis, -1), (g, h), d, adjoint)
    return out[..., 0, :].movedim(-1, axis), out[..., 1, :].movedim(-1, axis)


def _check_nd(dims, level: int) -> None:
    if level < 1 or level > MAX_DECOMPOSITION_LEVEL:
        raise ValueError(f"level must be in [1, {MAX_DECOMPOSITION_LEVEL}]")
    theo = min(d.bit_length() for d in dims) - 1
    if level > theo:
        raise ValueError(f"level {level} exceeds theoretical limit {theo} "
                         f"for shape {tuple(dims)}")


def _modwt2_direct(x: torch.Tensor, wavelet: DiscreteWavelet,
                   level: int) -> torch.Tensor:
    """The separable cascade in ``x``'s dtype: column pass (g, h) sharing
    its rolls, then the row pass on each — the order fixes the letters."""
    g, h = (taps_as(f, x.dtype) for f in modwt_base_filters(wavelet))
    rows = []
    ll = x
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        cl, ch = _conv_axis_pair(ll, g, h, d, -1)   # col pass (last axis)
        ll, hl = _conv_axis_pair(cl, g, h, d, -2)   # row pass, shared rolls
        lh, hh = _conv_axis_pair(ch, g, h, d, -2)
        rows.extend([lh, hl, hh])
    rows.append(ll)
    return torch.stack(rows, dim=0)


def _imodwt2_direct(coeffs: torch.Tensor, wavelet: DiscreteWavelet
                    ) -> torch.Tensor:
    """The adjoint cascade in ``coeffs``' dtype: undo the row pass, then
    the column pass, siblings combined before each shift."""
    g, h = (taps_as(f, coeffs.dtype) for f in modwt_base_filters(wavelet))
    level = (coeffs.shape[0] - 1) // 3
    ll = coeffs[3 * level]
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        lh, hl, hh = (coeffs[3 * (j - 1) + k] for k in range(3))
        cl = _combined_adjoint(ll, hl, g, h, d, dim=-2)
        ch = _combined_adjoint(lh, hh, g, h, d, dim=-2)
        ll = _combined_adjoint(cl, ch, g, h, d)
    return ll


def _try_kernel2(a: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                 inverse: bool = False):
    """Dispatch a 2D transform to the fused CUDA kernel when device, dtype,
    shape and autograd allow (the counterpart of ``_try_pallas2`` and of
    the inverse gate).

    Decided before any launch: CUDA float32/bfloat16 tensors of ndim 2/3
    (forward) or 3/4 (inverse) at shapes :func:`kernel2d_supported` admits.
    A tensor that requires a gradient returns None (the plain path): the 2D
    kernels have no backward, as the JAX package's have no VJP.
    """
    from ..kernels import modwt2_cuda as k2
    from ..kernels._launch import DTYPE_CODES

    if (not a.is_cuda or a.dtype not in DTYPE_CODES or a.requires_grad
            or a.ndim not in ((3, 4) if inverse else (2, 3))):
        return None
    r, c = a.shape[-2:]
    if not k2.kernel2d_supported(r, c, level, wavelet.length,
                                 "inv" if inverse else "fwd"):
        return None
    a = a.contiguous()
    if inverse:
        out = k2.modwt2_inv_cuda(a.reshape(a.shape[0], -1, r, c), wavelet)
        return out.reshape(a.shape[1:])
    out = k2.modwt2_fwd_cuda(a.reshape(-1, r, c), wavelet, level)
    return out.reshape((3 * level + 1,) + tuple(a.shape))


def modwt2(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
           method: str = "auto") -> torch.Tensor:
    """Forward 2D MODWT over the last two axes (any sizes).

    Returns ``(3·level+1, ..., R, C)`` on ``x``'s device, in the band order
    of the module docstring.  ``method``: 'auto' (the fused CUDA kernel for
    CUDA f32/bf16 input of ndim 2 or 3 when the shape allows, else the
    plain path), 'pallas' (the kernel; the JAX package's spelling — raises
    where it cannot run), or 'direct' (the plain separable path).
    """
    x = _as_signal(x)
    _check_nd(x.shape[-2:], level)
    if method in ("auto", "pallas"):
        out = _try_kernel2(x, wavelet, level)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused 2D kernel unavailable for shape {tuple(x.shape)} "
                f"dtype {x.dtype} on device {x.device}"
                f"{' (requires_grad)' if x.requires_grad else ''}")
    elif method != "direct":
        raise ValueError(f"unknown method {method!r}")
    return _modwt2_direct(x, wavelet, level)


def imodwt2(coeffs: torch.Tensor, wavelet: DiscreteWavelet,
            method: str = "auto") -> torch.Tensor:
    """Inverse 2D MODWT: ``(3·level+1, ..., R, C)`` → ``(..., R, C)``.

    ``method`` as in :func:`modwt2` (the fused kernel takes
    ``(3L+1, [B,] R, C)`` f32/bf16 stacks on a CUDA device).
    """
    coeffs = as_input(coeffs)
    if coeffs.shape[0] % 3 != 1:
        raise ValueError(
            f"2D MODWT coefficient stack must have 3·level+1 rows, got "
            f"{coeffs.shape[0]}")
    level = (coeffs.shape[0] - 1) // 3
    if method in ("auto", "pallas"):
        out = _try_kernel2(coeffs, wavelet, level, inverse=True)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused 2D inverse unavailable for shape "
                f"{tuple(coeffs.shape)} dtype {coeffs.dtype} on device "
                f"{coeffs.device}"
                f"{' (requires_grad)' if coeffs.requires_grad else ''}")
    elif method != "direct":
        raise ValueError(f"unknown method {method!r}")
    return _imodwt2_direct(coeffs, wavelet)


def modwt2_mra(x: torch.Tensor, wavelet: DiscreteWavelet,
               level: int) -> torch.Tensor:
    """Additive 2D MRA: per-band components summing to the image,
    ``(3·level+1, ..., R, C)``."""
    c = modwt2(x, wavelet, level)
    comps = []
    for i in range(c.shape[0]):
        ci = torch.zeros_like(c)
        ci[i] = c[i]
        comps.append(imodwt2(ci, wavelet))
    return torch.stack(comps, dim=0)


# ---------------------------------------------------------------------------
# 3D — the octant cascade over (D, R, C)
# ---------------------------------------------------------------------------

def _modwt3_direct(x: torch.Tensor, wavelet: DiscreteWavelet,
                   level: int) -> torch.Tensor:
    """The separable octant cascade in ``x``'s dtype: column pass, row pass
    on each column output, depth pass on each quadrant."""
    g, h = (taps_as(f, x.dtype) for f in modwt_base_filters(wavelet))
    rows = []
    lll = x
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        cl, ch = _conv_axis_pair(lll, g, h, d, -1)    # col pass
        rll, rhl = _conv_axis_pair(cl, g, h, d, -2)   # row pass
        rlh, rhh = _conv_axis_pair(ch, g, h, d, -2)
        # depth pass: order (depth, row, col) = (b2, b1, b0) binary octants
        lll, hll = _conv_axis_pair(rll, g, h, d, -3)
        llh, hlh = _conv_axis_pair(rlh, g, h, d, -3)
        lhl, hhl = _conv_axis_pair(rhl, g, h, d, -3)
        lhh, hhh = _conv_axis_pair(rhh, g, h, d, -3)
        rows.extend([llh, lhl, lhh, hll, hlh, hhl, hhh])
    rows.append(lll)
    return torch.stack(rows, dim=0)


def _imodwt3_direct(coeffs: torch.Tensor, wavelet: DiscreteWavelet
                    ) -> torch.Tensor:
    """The adjoint cascade in ``coeffs``' dtype: undo the depth pass per
    (row, col) quadrant, then the rows, then the columns, siblings combined
    before each shift."""
    g, h = (taps_as(f, coeffs.dtype) for f in modwt_base_filters(wavelet))
    level = (coeffs.shape[0] - 1) // 7
    lll = coeffs[7 * level]
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        llh, lhl, lhh, hll, hlh, hhl, hhh = (
            coeffs[7 * (j - 1) + k] for k in range(7))
        rll = _combined_adjoint(lll, hll, g, h, d, dim=-3)
        rlh = _combined_adjoint(llh, hlh, g, h, d, dim=-3)
        rhl = _combined_adjoint(lhl, hhl, g, h, d, dim=-3)
        rhh = _combined_adjoint(lhh, hhh, g, h, d, dim=-3)
        cl = _combined_adjoint(rll, rhl, g, h, d, dim=-2)
        ch = _combined_adjoint(rlh, rhh, g, h, d, dim=-2)
        lll = _combined_adjoint(cl, ch, g, h, d)
    return lll


def _try_kernel3(a: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                 inverse: bool = False):
    """Dispatch a 3D transform to the fused CUDA kernel when device, dtype,
    shape and autograd allow (the counterpart of ``_try_pallas3``).

    Decided before any launch: CUDA float32/bfloat16 tensors of ndim 3/4
    (forward) or 4/5 (inverse) at shapes :func:`kernel3d_supported` admits.
    A tensor that requires a gradient returns None (the plain path): the 3D
    kernels have no backward, as the JAX package's have no VJP.
    """
    from ..kernels import modwt3_cuda as k3
    from ..kernels._launch import DTYPE_CODES

    if (not a.is_cuda or a.dtype not in DTYPE_CODES or a.requires_grad
            or a.ndim not in ((4, 5) if inverse else (3, 4))):
        return None
    d, r, c = a.shape[-3:]
    if not k3.kernel3d_supported(d, r, c, level, wavelet.length,
                                 "inv" if inverse else "fwd"):
        return None
    a = a.contiguous()
    if inverse:
        out = k3.modwt3_inv_cuda(a.reshape(a.shape[0], -1, d, r, c), wavelet)
        return out.reshape(a.shape[1:])
    out = k3.modwt3_fwd_cuda(a.reshape(-1, d, r, c), wavelet, level)
    return out.reshape((7 * level + 1,) + tuple(a.shape))


def modwt3(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
           method: str = "auto") -> torch.Tensor:
    """Forward 3D MODWT over the last three axes (any sizes).

    Returns ``(7·level+1, ..., D, R, C)`` on ``x``'s device, in the octant
    order of the module docstring.  ``method``: 'auto' (the fused CUDA
    kernel for CUDA f32/bf16 input of ndim 3 or 4 when the shape allows,
    else the plain path), 'pallas' (the kernel; the JAX package's spelling —
    raises where it cannot run), or 'direct' (the plain separable path).
    """
    x = _as_signal(x)
    _check_nd(x.shape[-3:], level)
    if method in ("auto", "pallas"):
        out = _try_kernel3(x, wavelet, level)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused 3D kernel unavailable for shape {tuple(x.shape)} "
                f"dtype {x.dtype} on device {x.device}"
                f"{' (requires_grad)' if x.requires_grad else ''}")
    elif method != "direct":
        raise ValueError(f"unknown method {method!r}")
    return _modwt3_direct(x, wavelet, level)


def imodwt3(coeffs: torch.Tensor, wavelet: DiscreteWavelet,
            method: str = "auto") -> torch.Tensor:
    """Inverse 3D MODWT: ``(7·level+1, ..., D, R, C)`` → ``(..., D, R, C)``.

    ``method`` as in :func:`modwt3` (the fused kernel takes
    ``(7L+1, [B,] D, R, C)`` f32/bf16 stacks on a CUDA device).
    """
    coeffs = as_input(coeffs)
    if coeffs.shape[0] % 7 != 1:
        raise ValueError(
            f"3D MODWT coefficient stack must have 7·level+1 rows, got "
            f"{coeffs.shape[0]}")
    level = (coeffs.shape[0] - 1) // 7
    if method in ("auto", "pallas"):
        out = _try_kernel3(coeffs, wavelet, level, inverse=True)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused 3D inverse unavailable for shape "
                f"{tuple(coeffs.shape)} dtype {coeffs.dtype} on device "
                f"{coeffs.device}"
                f"{' (requires_grad)' if coeffs.requires_grad else ''}")
    elif method != "direct":
        raise ValueError(f"unknown method {method!r}")
    return _imodwt3_direct(coeffs, wavelet)


def modwt3_mra(x: torch.Tensor, wavelet: DiscreteWavelet,
               level: int) -> torch.Tensor:
    """Additive 3D MRA: per-band components summing to the volume,
    ``(7·level+1, ..., D, R, C)``."""
    c = modwt3(x, wavelet, level)
    comps = []
    for i in range(c.shape[0]):
        ci = torch.zeros_like(c)
        ci[i] = c[i]
        comps.append(imodwt3(ci, wavelet))
    return torch.stack(comps, dim=0)
