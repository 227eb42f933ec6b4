"""Fused 3D MODWT kernels for the H100 (``csrc/modwt3.cu``).

Replaces ``jwave_pro_tpu/kernels/modwt3_pallas.py``:

* ``jw_modwt3_fwd_kernel`` ← ``_fwd3_kernel`` (``:172``): (B, D, R, C) →
  ``(7L+1, B, D, R, C)``, per level the detail octants (LLH, LHL, LHH, HLL,
  HLH, HHL, HHH), LLL_L last.
* ``jw_modwt3_inv_level`` ← ``_inv3_kernel`` (``:331``): the adjoint.

The TPU's merged ``(D, R·C)`` lane layout, its two-roll column select, the
VMEM plans and the depth/row padding stay behind.  A 3D window pays its
halo on all three axes, so a block reaching back the whole cascade
(H = (M−1)(2^L − 1), 21 at Db4 L2) would leave almost no tile in 227 KB:
both directions run the levels in turn, LLL_j between levels in an f32
scratch volume the wrapper allocates, and read the volume as
``x[b, p mod D, q mod R, s mod C]`` — no padded copy, any volume, halo
larger than an axis included.

The forward is one cooperative launch with a grid-wide barrier between
levels: at level j a block owns a Td × Tr × Tc tile and a (Td + h) ×
(Tr + h) × 32 window, h = (M−1)·2^(j−1), Tc = 32 − h; three f32 windows fill
its shared memory.  Bound by the cascade's shared-memory traffic (9M loads
and 14M multiply-adds per window voxel and level), inflated by the window's
recompute ratio (2.5 at Db4 level 1, 9.7 at level 2).

The inverse is one launch per level, in stream order.  The per-axis
adjoints commute, so a level is the depth adjoint of two in-plane adjoints
Q_L, Q_H (each of the four bands with that depth letter).  A block owns a
16 × 32 column of the volume and a run of ``dc`` depth planes
(:func:`inv3_depth_run`) and marches along depth: each Q plane is computed
once from eight staged (16 + h) × (32 + h) band patches and kept in a ring
of M planes in shared memory, each output plane read from the ring.  Every
band voxel leaves device memory once, plus its in-plane halo; depth is
recomputed only where a run starts (h extra planes).  Bound by the
in-plane adjoints' shared-memory loads, 2M((16 + h)/4 + 3) per output voxel
and level.

:func:`kernel3d_supported` admits a level of the forward when its tile is at
least ``TILE3_MIN`` on every axis (h ≤ 20: Db4 to L2, Haar to L5, Symlet 8
at L1), and a level of the inverse when its patches and ring fit
(:func:`inv3_fits`: h ≤ 21).  Deeper levels and longer filters take the
plain path under ``method='auto'`` and raise under ``'pallas'``.

Beside each kernel: its plain PyTorch version (``modwt3_fwd_plain``,
``modwt3_inv_plain``) and a launch counter (``<launcher>.launches``, one a
call).  bfloat16 is read and written as bfloat16 and computed in float32
(the scratch stays float32).  Not differentiable: the JAX kernels have no
VJP, and the dispatch gate (``ops/modwt2d.py:_try_kernel3``) sends a tensor
that requires a gradient to the plain path.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.modwt2d import _check_nd, _imodwt3_direct, _modwt3_direct
from ..wavelets.base import DiscreteWavelet
from . import _build
from .modwt2_cuda import _check_device
from .modwt_cuda import (
    _I, _P, DTYPE_CODES, MAX_TAPS, SMEM_LIMIT, _compute_dtype,
    check_operand, kernel_taps,
)

__all__ = [
    "modwt3_fused", "imodwt3_fused", "kernel3d_supported", "tile3d",
    "inv3_fits", "inv3_depth_run", "modwt3_fwd_cuda", "modwt3_inv_cuda",
    "modwt3_fwd_plain", "modwt3_inv_plain",
]

TILE3_WC = 32        # window extent along C (JW3_WC): one warp's lanes
TILE3_MIN = 4        # smallest tile side a level may take
MAX_LEVELS3 = 8      # JW3_MAX_LEVELS
# window depth × rows that three f32 windows of 32 columns may take
WIN3_AREA = (SMEM_LIMIT - 4 * 2 * MAX_TAPS) // (4 * 3 * TILE3_WC)
# the inverse's block column (JW3I_TR × JW3I_TC) and the patch voxels one
# band may have (JW3I_NL × JW_THREADS)
INV3_TR, INV3_TC = 16, 32
INV3_PATCH = 4 * 512
SM_SMEM = 233_472    # shared memory of one H100 SM (228 KB)


def level_halo(m: int, j: int) -> int:
    """Context one level-j output needs on each axis: (M−1)·2^(j−1)."""
    return (m - 1) << (j - 1)


@functools.lru_cache(maxsize=None)
def tile3d(h: int):
    """(Td, Tr, Tc) of a level with halo ``h``: Tc = 32 − h, and the
    (Td, Tr) with the largest product whose (Td + h)(Tr + h) window rows
    fit ``WIN3_AREA``; None if a side would fall below ``TILE3_MIN``."""
    tc = TILE3_WC - h
    best = None
    for wd in range(h + TILE3_MIN, WIN3_AREA + 1):
        wr = WIN3_AREA // wd
        if wr < wd:
            break
        td, tr = wd - h, wr - h
        if best is None or td * tr > best[0] * best[1]:
            best = (td, tr)
    if best is None or tc < TILE3_MIN:
        return None
    return best[0], best[1], tc


def smem3d_bytes(level: int, m: int) -> int:
    """Dynamic shared memory of one block: the taps and three f32 windows
    of the level with the largest window."""
    rows = max((t[0] + h) * (t[1] + h) for h, t in (
        (level_halo(m, j), tile3d(level_halo(m, j)))
        for j in range(1, level + 1)))
    return 4 * (2 * MAX_TAPS + 3 * rows * TILE3_WC)


def inv3_smem_bytes(h: int, m: int) -> int:
    """Dynamic shared memory of one inverse block at halo ``h``: the taps,
    eight (16 + h) × (32 + h) band patches, four column adjoints of
    (16 + h) × 32 and the two rings of M 16 × 32 planes."""
    pr, pc = INV3_TR + h, INV3_TC + h
    return 4 * (2 * MAX_TAPS + 8 * pr * pc + 4 * pr * INV3_TC
                + 2 * m * INV3_TR * INV3_TC)


def inv3_fits(h: int, m: int) -> bool:
    """Whether a level of the inverse at halo ``h`` fits: its patches
    within the block's staging plan and its shared memory within 227 KB."""
    return ((INV3_TR + h) * (INV3_TC + h) <= INV3_PATCH and m <= MAX_TAPS
            and inv3_smem_bytes(h, m) <= SMEM_LIMIT)


def inv3_depth_run(b: int, d: int, r: int, c: int, h: int, m: int,
                   sms: int) -> int:
    """Depth planes one inverse block walks at halo ``h`` on a card of
    ``sms`` SMs: enough runs that the grid holds about four times the
    resident blocks, but no run shorter than max(2h, 8) planes (a run
    recomputes h planes) unless the volume is."""
    per_sm = max(1, min(2, SM_SMEM // (inv3_smem_bytes(h, m) + 1024)))
    tiles = b * -(-r // INV3_TR) * -(-c // INV3_TC)
    runs = max(1, -(-4 * sms * per_sm // tiles))
    return min(d, max(-(-d // runs), 2 * h, 8))


def kernel3d_supported(d: int, r: int, c: int, level: int, m: int,
                       kind: str = "fwd") -> bool:
    """Whether the 3D kernel ``kind`` ('fwd', 'inv') runs a D × R × C
    volume at this level and filter length.

    The counterpart of the JAX package's ``pallas3d_supported``, re-derived
    from the 227 KB shared-memory budget: any D, R and C (halo larger than
    an axis included), as long as every level fits — for the forward a
    tile of at least ``TILE3_MIN`` on each side, level halo (M−1)·2^(j−1)
    ≤ 20: Db4 to L2, Haar to L5, Symlet 8 at L1; for the inverse its
    patches and ring (:func:`inv3_fits`), halo ≤ 21.
    """
    if kind not in ("fwd", "inv"):
        raise ValueError(f"unknown 3D kernel kind {kind!r}")
    fits = ((lambda h: tile3d(h) is not None) if kind == "fwd"
            else (lambda h: inv3_fits(h, m)))
    return (all(1 <= n < 2 ** 31 for n in (d, r, c))
            and 1 <= level <= MAX_LEVELS3 and 1 <= m <= MAX_TAPS
            and all(fits(level_halo(m, j)) for j in range(1, level + 1)))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def modwt3_fwd_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                     level: int) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: ``(..., D, R, C)``
    → ``(7·level+1, ..., D, R, C)``, computed in float32 (float64 for
    float64 input) and returned in ``x``'s dtype."""
    cdt = _compute_dtype(x.dtype)
    return _modwt3_direct(x.to(cdt), wavelet, level).to(x.dtype)


def modwt3_inv_plain(c: torch.Tensor, wavelet: DiscreteWavelet
                     ) -> torch.Tensor:
    """The inverse kernel's function in plain PyTorch: ``(7·level+1, ...,
    D, R, C)`` → ``(..., D, R, C)``, computed like
    :func:`modwt3_fwd_plain`."""
    cdt = _compute_dtype(c.dtype)
    return _imodwt3_direct(c.to(cdt), wavelet).to(c.dtype)


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library()
    lib.jw_modwt3_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                                  _P, _P, ctypes.c_longlong, _I, _I, _I, _P]
    lib.jw_modwt3_inv.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                                  _P, _I, _I, _P]
    lib.jw_modwt3_fwd.restype = lib.jw_modwt3_inv.restype = _I
    return lib


def _scratch(src: torch.Tensor, shape, level: int) -> torch.Tensor:
    """LLL between levels: min(L−1, 2) f32 volumes (ping-pong)."""
    return torch.empty((min(level - 1, 2),) + tuple(shape),
                       dtype=torch.float32, device=src.device)


def modwt3_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """Launch the forward kernel: x (B, D, R, C) → (7·level+1, B, D, R, C)."""
    check_operand(x, "x", 4)
    b, d, r, c = x.shape
    m = wavelet.length
    if not kernel3d_supported(d, r, c, level, m, "fwd"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for the 3D forward kernel")
    out = torch.empty((7 * level + 1,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    tiles = [tile3d(level_halo(m, j)) for j in range(1, level + 1)]
    td = np.array([t[0] for t in tiles], dtype=np.int32)
    tr = np.array([t[1] for t in tiles], dtype=np.int32)
    most = max(b * -(-d // t[0]) * -(-r // t[1]) * -(-c // t[2])
               for t in tiles)
    scratch = _scratch(x, x.shape, level)
    g, h = kernel_taps(wavelet)
    lib = _lib()
    code = lib.jw_modwt3_fwd(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, d, r, c,
        level, g.ctypes.data, h.ctypes.data, m, td.ctypes.data,
        tr.ctypes.data, most, smem3d_bytes(level, m), DTYPE_CODES[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "3D forward kernel")
    modwt3_fwd_cuda.launches += 1
    return out


modwt3_fwd_cuda.launches = 0


def modwt3_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet
                    ) -> torch.Tensor:
    """Launch the inverse kernel, one launch per level in stream order
    (counted once a call): c (7·level+1, B, D, R, C) → (B, D, R, C)."""
    check_operand(c, "coeffs", 5)
    if c.shape[0] % 7 != 1:
        raise ValueError(f"coeffs: need 7·level+1 bands, got {c.shape[0]}")
    level = (c.shape[0] - 1) // 7
    b, d, r, cols = c.shape[1:]
    m = wavelet.length
    if not kernel3d_supported(d, r, cols, level, m, "inv"):
        raise ValueError(f"unsupported shape {tuple(c.shape[1:])} level "
                         f"{level} for the 3D inverse kernel")
    out = torch.empty(tuple(c.shape[1:]), dtype=c.dtype, device=c.device)
    sms = torch.cuda.get_device_properties(c.device).multi_processor_count
    dc = np.array([inv3_depth_run(b, d, r, cols, level_halo(m, j), m, sms)
                   for j in range(1, level + 1)], dtype=np.int32)
    scratch = _scratch(c, c.shape[1:], level)
    g, h = kernel_taps(wavelet)
    lib = _lib()
    code = lib.jw_modwt3_inv(
        c.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, d, r, cols,
        level, g.ctypes.data, h.ctypes.data, m, dc.ctypes.data,
        DTYPE_CODES[c.dtype], c.device.index,
        torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(lib, code, "3D inverse kernel")
    modwt3_inv_cuda.launches += 1
    return out


modwt3_inv_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatch by device
# ---------------------------------------------------------------------------

def modwt3_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                 level: int) -> torch.Tensor:
    """Fused forward 3D MODWT: (B, D, R, C) → (7·level+1, B, D, R, C),
    (D, R, C) → (7·level+1, D, R, C).

    A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
    version.  Raises for shapes :func:`kernel3d_supported` rejects.
    """
    if x.ndim not in (3, 4):
        raise ValueError(f"fused 3D MODWT takes (D, R, C) or (B, D, R, C), "
                         f"got {tuple(x.shape)}")
    d, r, c = x.shape[-3:]
    _check_nd((d, r, c), level)
    if not kernel3d_supported(d, r, c, level, wavelet.length, "fwd"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for fused 3D MODWT")
    _check_device(x, "3D forward")
    if x.is_cuda:
        out = modwt3_fwd_cuda(x.contiguous().reshape(-1, d, r, c), wavelet,
                              level)
        return out.reshape((7 * level + 1,) + tuple(x.shape))
    return modwt3_fwd_plain(x, wavelet, level)


def imodwt3_fused(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Fused inverse 3D MODWT: (7·level+1, B, D, R, C) → (B, D, R, C),
    (7·level+1, D, R, C) → (D, R, C); dispatched as :func:`modwt3_fused`."""
    if c.ndim not in (4, 5) or c.shape[0] % 7 != 1:
        raise ValueError(f"fused 3D iMODWT takes a (7L+1, [B,] D, R, C) "
                         f"stack, got {tuple(c.shape)}")
    level = (c.shape[0] - 1) // 7
    d, r, cols = c.shape[-3:]
    if not kernel3d_supported(d, r, cols, level, wavelet.length, "inv"):
        raise ValueError(f"unsupported shape {tuple(c.shape)} for fused 3D "
                         f"iMODWT")
    _check_device(c, "3D inverse")
    if c.is_cuda:
        out = modwt3_inv_cuda(
            c.contiguous().reshape(c.shape[0], -1, d, r, cols), wavelet)
        return out.reshape(tuple(c.shape[1:]))
    return modwt3_inv_plain(c, wavelet)
