"""Fused 3D MODWT kernels for the H100 (``csrc/modwt3.cu``).

Replaces ``jwave_pro_tpu/kernels/modwt3_pallas.py``:

* ``jw_modwt3_fwd_level`` ← ``_fwd3_kernel`` (``:172``): (B, D, R, C) →
  ``(7L+1, B, D, R, C)``, per level the detail octants (LLH, LHL, LHH, HLL,
  HLH, HHL, HHH), LLL_L last.
* ``jw_modwt3_inv_level`` ← ``_inv3_kernel`` (``:331``): the adjoint.

The TPU's merged ``(D, R·C)`` lane layout, its two-roll column select, the
VMEM plans and the depth/row padding stay behind.  A 3D window pays its
halo on all three axes, so a block reaching back the whole cascade
(H = (M−1)(2^L − 1), 21 at Db4 L2) would leave almost no tile in 227 KB:
both directions run the levels in turn, one launch a level in stream order,
LLL_j between levels in an f32 scratch volume the wrapper allocates, and
read the volume as ``x[b, p mod D, q mod R, s mod C]`` — no padded copy,
any volume, halo larger than an axis included.  Both march a block along
a run of depth planes over a Tr × 32 column of the volume (runs from
:func:`depth_run`, enough blocks to fill the card), keep a ring of M planes
in shared memory, and compute every plane once; depth is recomputed only
where a run or a residue mod 2^(j−1) starts.

The forward (level j, halo h = (M−1)·2^(j−1)) stages a (Tr + h) × (32 + h)
patch of LLL_{j−1} a plane, runs the column and row passes into four
quadrant rings, and writes each output plane's seven octants and LLL_j from
the rings; Tr from :func:`fwd3_rows` (16 at Db4, two blocks an SM).  Bound
by device memory (one read and eight writes a voxel and level) and about
7M shared loads an output voxel and level.

The inverse is the depth adjoint of two in-plane adjoints Q_L, Q_H (each of
the four bands with that depth letter): each Q plane is computed once from
eight staged (16 + h) × (32 + h) band patches and kept in a ring, each
output plane read from the ring.  Bound by the in-plane adjoints' shared
loads, 2M((16 + h)/4 + 3) per output voxel and level.

:func:`kernel3d_supported` admits every level whose halo is at most
``MAX_HALO3`` = 21 (the inverse's patch plan, :func:`inv3_fits`; the
forward takes the same range so every forward it runs has its inverse):
Db4 to L2, Haar to L5, Symlet 8 at L1.  Deeper levels and longer filters
take the plain path under ``method='auto'`` and raise under ``'pallas'``.

Beside each kernel: its plain PyTorch version (``modwt3_fwd_plain``,
``modwt3_inv_plain``) and a launch count (``modwt_cuda.LAUNCHES["<op>"]``,
one a call).  Each call is an operator (``jwave::modwt3_fwd``,
``jwave::modwt3_inv``) that plans its depth runs from the concrete batch.
bfloat16 is read and written as bfloat16 and computed in float32
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
    _I, _P, DTYPE_CODES, MAX_TAPS, SMEM_LIMIT, _compute_dtype, check_operand,
    check_taps, host_taps, op_taps, kernel_op,
)

__all__ = [
    "modwt3_fused", "imodwt3_fused", "kernel3d_supported", "fwd3_rows",
    "fwd3_smem_bytes", "inv3_fits", "depth_run", "fwd3_depth_run",
    "inv3_depth_run", "modwt3_fwd_cuda", "modwt3_inv_cuda",
    "modwt3_fwd_plain", "modwt3_inv_plain", "modwt3_fwd_op",
    "modwt3_inv_op",
]

MAX_LEVELS3 = 8
# a block's columns (JW3F_TC, JW3I_TC): one warp's lanes; the inverse's
# block rows (JW3I_TR) and the patch voxels one band may have (JW3I_NL ×
# JW_THREADS)
TILE3_TC = 32
INV3_TR = 16
INV3_PATCH = 4 * 512
MAX_HALO3 = 21       # the largest level halo both directions take
FWD3_ROWS = (64, 48, 32, 16)   # the forward's block rows, largest first
SM_SMEM = 233_472    # shared memory of one H100 SM (228 KB)


def level_halo(m: int, j: int) -> int:
    """Context one level-j output needs on each axis: (M−1)·2^(j−1)."""
    return (m - 1) << (j - 1)


def _per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes one SM holds (1 KB reserved each), at most
    the two that ``__launch_bounds__(512, 2)`` plans registers for."""
    return max(0, min(2, SM_SMEM // (smem + 1024)))


def fwd3_smem_bytes(h: int, m: int, tr: int) -> int:
    """Dynamic shared memory of one forward block at halo ``h`` with ``tr``
    rows: the taps, the (tr + h) × (32 + h) patch, cl and ch on
    (tr + h) × 32, and four quadrant rings of M tr × 32 planes."""
    pr = tr + h
    return 4 * (2 * MAX_TAPS + pr * (TILE3_TC + h) + 2 * pr * TILE3_TC
                + 4 * m * tr * TILE3_TC)


@functools.lru_cache(maxsize=None)
def fwd3_rows(h: int, m: int):
    """The forward block's rows at halo ``h``: the most (of ``FWD3_ROWS``)
    with which two blocks fit an SM, else 16 if one block fits 227 KB;
    None if the level is out of the kernel's range."""
    if not (0 <= h <= MAX_HALO3 and 1 <= m <= MAX_TAPS):
        return None
    for tr in FWD3_ROWS:
        if _per_sm(fwd3_smem_bytes(h, m, tr)) >= 2:
            return tr
    return 16 if fwd3_smem_bytes(h, m, 16) <= SMEM_LIMIT else None


def inv3_smem_bytes(h: int, m: int) -> int:
    """Dynamic shared memory of one inverse block at halo ``h``: the taps,
    eight (16 + h) × (32 + h) band patches, four column adjoints of
    (16 + h) × 32 and the two rings of M 16 × 32 planes."""
    pr, pc = INV3_TR + h, TILE3_TC + h
    return 4 * (2 * MAX_TAPS + 8 * pr * pc + 4 * pr * TILE3_TC
                + 2 * m * INV3_TR * TILE3_TC)


def inv3_fits(h: int, m: int) -> bool:
    """Whether a level of the inverse at halo ``h`` fits: its patches
    within the block's staging plan and its shared memory within 227 KB."""
    return ((INV3_TR + h) * (TILE3_TC + h) <= INV3_PATCH and m <= MAX_TAPS
            and inv3_smem_bytes(h, m) <= SMEM_LIMIT)


def depth_run(tiles: int, d: int, h: int, per_sm: int, sms: int) -> int:
    """Depth planes one marching block walks: enough runs that the grid of
    ``tiles`` in-plane columns holds about four times the resident blocks
    (``per_sm`` a SM on ``sms`` SMs), but no run shorter than max(2h, 8)
    planes (a run recomputes h planes) unless the volume is."""
    runs = max(1, -(-4 * sms * max(1, per_sm) // tiles))
    return min(d, max(-(-d // runs), 2 * h, 8))


def fwd3_depth_run(b: int, d: int, r: int, c: int, h: int, m: int,
                   sms: int) -> int:
    """:func:`depth_run` of a forward level at halo ``h``."""
    tr = fwd3_rows(h, m)
    return depth_run(b * -(-r // tr) * -(-c // TILE3_TC), d, h,
                     _per_sm(fwd3_smem_bytes(h, m, tr)), sms)


def inv3_depth_run(b: int, d: int, r: int, c: int, h: int, m: int,
                   sms: int) -> int:
    """:func:`depth_run` of an inverse level at halo ``h``."""
    return depth_run(b * -(-r // INV3_TR) * -(-c // TILE3_TC), d, h,
                     _per_sm(inv3_smem_bytes(h, m)), sms)


def kernel3d_supported(d: int, r: int, c: int, level: int, m: int,
                       kind: str = "fwd") -> bool:
    """Whether the 3D kernel ``kind`` ('fwd', 'inv') runs a D × R × C
    volume at this level and filter length.

    The counterpart of the JAX package's ``pallas3d_supported``, re-derived
    from the 227 KB shared-memory budget: any D, R and C (halo larger than
    an axis included), as long as every level fits — level halo
    (M−1)·2^(j−1) ≤ 21 with its patch and rings in shared memory
    (:func:`fwd3_rows`, :func:`inv3_fits`): Db4 to L2, Haar to L5,
    Symlet 8 at L1.
    """
    if kind not in ("fwd", "inv"):
        raise ValueError(f"unknown 3D kernel kind {kind!r}")
    fits = ((lambda h: fwd3_rows(h, m) is not None) if kind == "fwd"
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
                                  _P, _P, _I, _I, _P]
    lib.jw_modwt3_inv.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                                  _P, _I, _I, _P]
    lib.jw_modwt3_fwd.restype = lib.jw_modwt3_inv.restype = _I
    return lib


def _scratch(src: torch.Tensor, shape, level: int) -> torch.Tensor:
    """LLL between levels: min(L−1, 2) f32 volumes (ping-pong)."""
    return torch.empty((min(level - 1, 2),) + tuple(shape),
                       dtype=torch.float32, device=src.device)


def _check_fwd3(x: torch.Tensor, g, h, level: int, traced: bool) -> None:
    check_operand(x, "x", 4, traced)
    if not kernel3d_supported(*x.shape[1:], level, check_taps(g, h), "fwd"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for the 3D forward kernel")


@kernel_op("modwt3_fwd")
def modwt3_fwd_op(x: torch.Tensor, g: list[float], h: list[float],
                  level: int) -> torch.Tensor:
    """The forward kernel's launches as an operator (``torch.ops.jwave.
    modwt3_fwd``), one launch per level in stream order (counted once a
    call): x (B, D, R, C) → (7·level+1, B, D, R, C).  The depth runs and
    the scratch are taken here, from the concrete batch."""
    _check_fwd3(x, g, h, level, False)
    b, d, r, c = x.shape
    m = len(g)
    out = torch.empty((7 * level + 1,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    halos = [level_halo(m, j) for j in range(1, level + 1)]
    tr = np.array([fwd3_rows(hl, m) for hl in halos], dtype=np.int32)
    dc = np.array([fwd3_depth_run(b, d, r, c, hl, m, sms) for hl in halos],
                  dtype=np.int32)
    scratch = _scratch(x, x.shape, level)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwt3_fwd(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, d, r, c,
        level, gh.ctypes.data, hh.ctypes.data, m, tr.ctypes.data,
        dc.ctypes.data, DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "3D forward kernel")
    return out


@modwt3_fwd_op.register_fake
def _(x, g, h, level):
    _check_fwd3(x, g, h, level, True)
    return x.new_empty((7 * level + 1,) + tuple(x.shape))


def modwt3_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """Launch the forward kernel as ``jwave::modwt3_fwd``: x
    (B, D, R, C) → (7·level+1, B, D, R, C)."""
    return modwt3_fwd_op(x, *op_taps(wavelet), level)


def _check_inv3(c: torch.Tensor, g, h, traced: bool) -> int:
    check_operand(c, "coeffs", 5, traced)
    if c.shape[0] % 7 != 1:
        raise ValueError(f"coeffs: need 7·level+1 bands, got {c.shape[0]}")
    level = (c.shape[0] - 1) // 7
    if not kernel3d_supported(*c.shape[2:], level, check_taps(g, h), "inv"):
        raise ValueError(f"unsupported shape {tuple(c.shape[1:])} level "
                         f"{level} for the 3D inverse kernel")
    return level


@kernel_op("modwt3_inv")
def modwt3_inv_op(c: torch.Tensor, g: list[float], h: list[float]
                  ) -> torch.Tensor:
    """The inverse kernel's launches as an operator (``torch.ops.jwave.
    modwt3_inv``), one launch per level in stream order (counted once a
    call): c (7·level+1, B, D, R, C) → (B, D, R, C)."""
    level = _check_inv3(c, g, h, False)
    b, d, r, cols = c.shape[1:]
    m = len(g)
    out = torch.empty(tuple(c.shape[1:]), dtype=c.dtype, device=c.device)
    sms = torch.cuda.get_device_properties(c.device).multi_processor_count
    dc = np.array([inv3_depth_run(b, d, r, cols, level_halo(m, j), m, sms)
                   for j in range(1, level + 1)], dtype=np.int32)
    scratch = _scratch(c, c.shape[1:], level)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwt3_inv(
        c.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, d, r, cols,
        level, gh.ctypes.data, hh.ctypes.data, m, dc.ctypes.data,
        DTYPE_CODES[c.dtype], c.device.index,
        torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(lib, code, "3D inverse kernel")
    return out


@modwt3_inv_op.register_fake
def _(c, g, h):
    _check_inv3(c, g, h, True)
    return c.new_empty(tuple(c.shape[1:]))


def modwt3_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet
                    ) -> torch.Tensor:
    """Launch the inverse kernel as ``jwave::modwt3_inv``: c
    (7·level+1, B, D, R, C) → (B, D, R, C)."""
    return modwt3_inv_op(c, *op_taps(wavelet))


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
