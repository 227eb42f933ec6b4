"""Fused 2D MODWT kernels for the H100 (``csrc/modwt2.cu``).

Replaces ``jwave_pro_tpu/kernels/modwt2_pallas.py``:

* ``jw_modwt2_fwd_kernel`` ← ``_fwd2_kernel`` (``:192``): (B, R, C) →
  ``(3L+1, B, R, C)``, bands (LH_j, HL_j, HH_j) per level, LL_L last.
* ``jw_modwt2_inv_kernel`` ← ``_inv2_kernel`` (``:314``): the adjoint.
* ``jw_modwt2_denoise_kernel`` ← ``_denoise2_kernel`` (``:460``):
  forward → shrink every detail band by one threshold per image → inverse,
  LL kept, in one launch.

Each block owns a T × T output tile and a square window around it: T + H
on a side for the transforms, reaching up/left (forward) or down/right
(inverse), T + 2H for the denoise, with H = (M−1)(2^L − 1).  It reads its
circular context ``x[b, p mod R, q mod C]`` directly — no padded copy, no
tile plan over (R, C) — so any image size runs, halo larger than the image
included.  Three f32 windows live in shared memory (the running LL and the
column pass's two outputs), which is the whole limit:
:func:`kernel2d_supported` derives the tile from the 227 KB budget and
refuses what does not fit (Db4 to L4 forward and inverse, L3 denoise).

What bounds them on the H100: shared-memory traffic of the cascade (3M
loads and 6M fused multiply-adds per window pixel and level), inflated by
the window's recompute ratio ((T+H)²/T², 3.1 at Db4 L3), and one block per
SM at the deeper levels.  The denoise cannot keep its 3L shrunk detail
bands in shared memory as the TPU kept them in VMEM: each block writes
them to a block-private scratch area in device memory (only the region the
adjoint reads back) and walks the tiles in a loop, with a grid sized to the
resident blocks, so the scratch stays bounded.

Beside each kernel: its plain PyTorch version (``modwt2_fwd_plain``,
``modwt2_inv_plain``, ``modwt2_denoise_plain``) and a launch counter
(``<launcher>.launches``).  bfloat16 is read and written as bfloat16 and
computed in float32.  Not differentiable: the JAX kernels have no VJP, and
the dispatch gate (``ops/modwt2d.py:_try_kernel2``) sends a tensor that
requires a gradient to the plain path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.denoise import hard_threshold, soft_threshold
from ..ops.modwt2d import _check_nd, _imodwt2_direct, _modwt2_direct
from ..wavelets.base import DiscreteWavelet
from . import _build
from .modwt_cuda import (
    _I, _P, DTYPE_CODES, MAX_TAPS, SMEM_LIMIT, _compute_dtype,
    check_operand, halo, kernel_taps,
)

__all__ = [
    "modwt2_fused", "imodwt2_fused", "modwt2_denoise_fused",
    "kernel2d_supported", "modwt2_fwd_cuda", "modwt2_inv_cuda",
    "modwt2_denoise_cuda", "modwt2_fwd_plain", "modwt2_inv_plain",
    "modwt2_denoise_plain",
]

TILE2D_MAX = 64     # largest tile side; larger tiles leave one block per SM


def window2d(tile: int, level: int, m: int, kind: str) -> int:
    """Side of a block's square window: T + H ('fwd', 'inv') or T + 2H
    ('denoise', whose analysis reaches up/left and synthesis down/right)."""
    return tile + (2 if kind == "denoise" else 1) * halo(m, level)


def smem2d_bytes(tile: int, level: int, m: int, kind: str) -> int:
    """Dynamic shared memory of one block: the taps and three f32 windows
    (LL, and the column pass's two outputs)."""
    return 4 * (2 * MAX_TAPS + 3 * window2d(tile, level, m, kind) ** 2)


def tile2d(level: int, m: int, kind: str) -> int:
    """The largest tile side (a multiple of 8, at most ``TILE2D_MAX``) whose
    windows fit a block's shared memory; 0 if none does."""
    for t in range(TILE2D_MAX, 7, -8):
        if smem2d_bytes(t, level, m, kind) <= SMEM_LIMIT:
            return t
    return 0


def kernel2d_supported(r: int, c: int, level: int, m: int, kind: str) -> bool:
    """Whether 2D kernel ``kind`` ('fwd', 'inv', 'denoise') runs an R × C
    image at this level and filter length.

    The counterpart of the JAX package's ``pallas2d_supported`` /
    ``denoise2_fused_supported``, re-derived from the 227 KB shared-memory
    budget: any R and C (halo larger than the image included), as long as
    an 8 × 8 tile's windows fit.  Db4 runs to L4 forward and inverse and to
    L3 denoise; Symlet 8 to L3 and L2; Haar to L7 and L6.
    """
    return (1 <= r < 2 ** 31 and 1 <= c < 2 ** 31 and level >= 1
            and 1 <= m <= MAX_TAPS and tile2d(level, m, kind) > 0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def modwt2_fwd_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                     level: int) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: ``(..., R, C)`` →
    ``(3·level+1, ..., R, C)``, computed in float32 (float64 for float64
    input) and returned in ``x``'s dtype."""
    cdt = _compute_dtype(x.dtype)
    return _modwt2_direct(x.to(cdt), wavelet, level).to(x.dtype)


def modwt2_inv_plain(c: torch.Tensor, wavelet: DiscreteWavelet
                     ) -> torch.Tensor:
    """The inverse kernel's function in plain PyTorch: ``(3·level+1, ...,
    R, C)`` → ``(..., R, C)``, computed like :func:`modwt2_fwd_plain`."""
    cdt = _compute_dtype(c.dtype)
    return _imodwt2_direct(c.to(cdt), wavelet).to(c.dtype)


def modwt2_denoise_plain(x: torch.Tensor, threshold: torch.Tensor,
                         wavelet: DiscreteWavelet, level: int,
                         mode: str = "soft") -> torch.Tensor:
    """The denoise kernel's function in plain PyTorch: x (B, R, C),
    threshold (B,) → (B, R, C).  Every detail band is shrunk by its image's
    threshold, LL kept; the chain runs in float32 (float64 for float64
    input) and rounds to ``x``'s dtype once, at the end."""
    cdt = _compute_dtype(x.dtype)
    c = _modwt2_direct(x.to(cdt), wavelet, level)
    shrink = soft_threshold if mode == "soft" else hard_threshold
    thr = threshold.to(dtype=cdt, device=x.device)[:, None, None]
    c = torch.cat([shrink(c[:3 * level], thr), c[3 * level:]], dim=0)
    return _imodwt2_direct(c, wavelet).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library()
    for fn in (lib.jw_modwt2_fwd, lib.jw_modwt2_inv):
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P]
        fn.restype = _I
    lib.jw_modwt2_denoise.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                      _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.jw_modwt2_denoise.restype = _I
    lib.jw_modwt2_denoise_blocks.argtypes = [_I, _I, _I, _P]
    lib.jw_modwt2_denoise_blocks.restype = _I
    return lib


def _plan(shape, level: int, wavelet: DiscreteWavelet, kind: str,
          what: str):
    """(tile, halo, shared-memory bytes) for an (B, R, C) launch; raises for
    what the kernel does not take."""
    b, r, c = shape
    m = wavelet.length
    if not kernel2d_supported(r, c, level, m, kind):
        raise ValueError(f"unsupported shape {tuple(shape)} level {level} "
                         f"for the {what} kernel")
    t = tile2d(level, m, kind)
    if b * -(-r // t) * -(-c // t) >= 2 ** 31:
        raise ValueError(f"{tuple(shape)} exceeds the {what} kernel grid")
    return t, halo(m, level), smem2d_bytes(t, level, m, kind)


def modwt2_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """Launch the forward kernel: x (B, R, C) → (3·level+1, B, R, C)."""
    check_operand(x, "x", 3)
    b, r, c = x.shape
    tile, hal, smem = _plan(x.shape, level, wavelet, "fwd", "2D forward")
    out = torch.empty((3 * level + 1, b, r, c), dtype=x.dtype,
                      device=x.device)
    g, h = kernel_taps(wavelet)
    lib = _lib()
    code = lib.jw_modwt2_fwd(
        x.data_ptr(), out.data_ptr(), b, r, c, level, g.ctypes.data,
        h.ctypes.data, wavelet.length, tile, hal, smem, DTYPE_CODES[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "2D forward kernel")
    modwt2_fwd_cuda.launches += 1
    return out


modwt2_fwd_cuda.launches = 0


def modwt2_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet
                    ) -> torch.Tensor:
    """Launch the inverse kernel: c (3·level+1, B, R, C) → (B, R, C)."""
    check_operand(c, "coeffs", 4)
    rows, b, r, cols = c.shape
    if rows % 3 != 1:
        raise ValueError(f"coeffs: need 3·level+1 bands, got {rows}")
    level = (rows - 1) // 3
    tile, hal, smem = _plan(c.shape[1:], level, wavelet, "inv", "2D inverse")
    out = torch.empty((b, r, cols), dtype=c.dtype, device=c.device)
    g, h = kernel_taps(wavelet)
    lib = _lib()
    code = lib.jw_modwt2_inv(
        c.data_ptr(), out.data_ptr(), b, r, cols, level, g.ctypes.data,
        h.ctypes.data, wavelet.length, tile, hal, smem, DTYPE_CODES[c.dtype],
        c.device.index, torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(lib, code, "2D inverse kernel")
    modwt2_inv_cuda.launches += 1
    return out


modwt2_inv_cuda.launches = 0


@functools.cache
def _resident_blocks(smem: int, dtype: int, device: int) -> int:
    """Blocks of the denoise kernel the card holds at once."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    code = lib.jw_modwt2_denoise_blocks(smem, dtype, device,
                                        ctypes.addressof(blocks))
    _build.check(lib, code, "2D denoise occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the 2D denoise kernel fits no block in "
                           f"{smem} bytes of shared memory")
    return blocks.value


def modwt2_denoise_cuda(x: torch.Tensor, threshold: torch.Tensor,
                        wavelet: DiscreteWavelet, level: int,
                        mode: str = "soft") -> torch.Tensor:
    """Launch the denoise kernel: x (B, R, C), threshold (B,) float32 →
    (B, R, C).  Allocates the blocks' detail-band scratch."""
    check_operand(x, "x", 3)
    b, r, c = x.shape
    if (threshold.dtype != torch.float32 or threshold.shape != (b,)
            or threshold.device != x.device
            or not threshold.is_contiguous()):
        raise ValueError("threshold: kernel needs a contiguous (B,) float32 "
                         "tensor on x's device")
    tile, hal, smem = _plan(x.shape, level, wavelet, "denoise", "2D denoise")
    dtype = DTYPE_CODES[x.dtype]
    tiles = b * -(-r // tile) * -(-c // tile)
    grid = min(tiles, _resident_blocks(smem, dtype, x.device.index))
    win = window2d(tile, level, wavelet.length, "denoise")
    scratch = torch.empty((grid, 3 * level, win, win), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    g, h = kernel_taps(wavelet)
    lib = _lib()
    code = lib.jw_modwt2_denoise(
        x.data_ptr(), threshold.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), grid, b, r, c, level, g.ctypes.data,
        h.ctypes.data, wavelet.length, tile, hal, smem, int(mode != "soft"),
        dtype, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "2D denoise kernel")
    modwt2_denoise_cuda.launches += 1
    return out


modwt2_denoise_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatch by device
# ---------------------------------------------------------------------------

def _check_device(a: torch.Tensor, what: str) -> None:
    if a.is_cuda:
        if a.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"the {what} kernel has no backward; use "
                             f"method='direct' for a differentiable call")
    elif a.device.type != "cpu":
        raise ValueError(f"no {what} kernel for device {a.device}")


def modwt2_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                 level: int) -> torch.Tensor:
    """Fused forward 2D MODWT: (B, R, C) → (3·level+1, B, R, C), (R, C) →
    (3·level+1, R, C).

    A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
    version.  Raises for shapes :func:`kernel2d_supported` rejects.
    """
    if x.ndim not in (2, 3):
        raise ValueError(f"fused 2D MODWT takes (R, C) or (B, R, C), got "
                         f"{tuple(x.shape)}")
    r, c = x.shape[-2:]
    _check_nd((r, c), level)
    if not kernel2d_supported(r, c, level, wavelet.length, "fwd"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for fused 2D MODWT")
    _check_device(x, "2D forward")
    if x.is_cuda:
        out = modwt2_fwd_cuda(x.contiguous().reshape(-1, r, c), wavelet,
                              level)
        return out.reshape((3 * level + 1,) + tuple(x.shape))
    return modwt2_fwd_plain(x, wavelet, level)


def imodwt2_fused(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Fused inverse 2D MODWT: (3·level+1, B, R, C) → (B, R, C),
    (3·level+1, R, C) → (R, C); dispatched as :func:`modwt2_fused`."""
    if c.ndim not in (3, 4) or c.shape[0] % 3 != 1:
        raise ValueError(f"fused 2D iMODWT takes a (3L+1, [B,] R, C) stack, "
                         f"got {tuple(c.shape)}")
    level = (c.shape[0] - 1) // 3
    r, cols = c.shape[-2:]
    if not kernel2d_supported(r, cols, level, wavelet.length, "inv"):
        raise ValueError(f"unsupported shape {tuple(c.shape)} for fused 2D "
                         f"iMODWT")
    _check_device(c, "2D inverse")
    if c.is_cuda:
        out = modwt2_inv_cuda(c.contiguous().reshape(c.shape[0], -1, r, cols),
                              wavelet)
        return out.reshape(tuple(c.shape[1:]))
    return modwt2_inv_plain(c, wavelet)


def modwt2_denoise_fused(x: torch.Tensor, threshold: torch.Tensor,
                         wavelet: DiscreteWavelet, level: int,
                         mode: str = "soft") -> torch.Tensor:
    """Single-pass 2D denoise: x (B, R, C) or (R, C), threshold (B,) (one
    per image; (1,) for an (R, C) input) → the denoised image(s).

    Shrinks every detail band, keeps LL (``ops.denoise.modwt2_denoise``
    with a fixed threshold).  A CUDA tensor runs the kernel or raises; a
    CPU tensor runs the plain version.  Raises for shapes
    :func:`kernel2d_supported` ('denoise') rejects.  Use
    ``ops.denoise.modwt2_denoise(method='fused')`` for the public path with
    the default threshold.
    """
    if x.ndim not in (2, 3):
        raise ValueError(f"fused 2D denoise takes (R, C) or (B, R, C), got "
                         f"{tuple(x.shape)}")
    r, c = x.shape[-2:]
    _check_nd((r, c), level)
    if not kernel2d_supported(r, c, level, wavelet.length, "denoise"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for fused 2D denoise")
    _check_device(x, "2D denoise")
    xb = x.reshape(-1, r, c)
    if x.is_cuda:
        out = modwt2_denoise_cuda(xb.contiguous(), threshold, wavelet, level,
                                  mode)
    else:
        out = modwt2_denoise_plain(xb, threshold, wavelet, level, mode)
    return out.reshape(x.shape)
