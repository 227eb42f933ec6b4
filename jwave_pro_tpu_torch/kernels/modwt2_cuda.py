"""Fused 2D MODWT kernels for the H100 (``csrc/modwt2.cu``).

Replaces ``jwave_pro_tpu/kernels/modwt2_pallas.py``:

* ``jw_modwt2_fwd_kernel`` ← ``_fwd2_kernel`` (``:192``): (B, R, C) →
  ``(3L+1, B, R, C)``, bands (LH_j, HL_j, HH_j) per level, LL_L last.
* ``jw_modwt2_inv_kernel`` ← ``_inv2_kernel`` (``:314``): the adjoint.
* ``jw_modwt2_denoise_kernel`` ← ``_denoise2_kernel`` (``:460``):
  forward → shrink every detail band by one threshold per image → inverse,
  LL kept, in one launch.

All three march: each block owns a strip of Tc output columns of one
image and a window of W columns read ``x[b, p mod R, q mod C]`` (no padded
copy, so any image size runs, halo H = (M−1)(2^L − 1) larger than the
image included), and marches down a run of rows, G rows a step, keeping in
shared memory only the rows each stage's taps reach.  Rows are never
recomputed but for a run's warm-up; columns by W / Tc.

* The forward: W = Tc + H, reaching left; one ring of (M−1)·2^(j−1) + G
  rows of LL_{j−1} a level; at each step every level's row pass, column
  pass and band stores.
* The inverse: W = Tc + H, reaching right; two rings a level (the column
  adjoints U_j = g′Z_j + h′LH_j and V_j = g′HL_j + h′HH_j, whose row
  adjoints sum to Z_{j−1}); each detail row is read from device memory
  once, at the row its level's synthesis reaches, so nothing waits.
* The denoise: W = Tc + 2H, four rings a level (the analysis's LL_{j−1},
  the shrunk details' column adjoints, the reconstruction's LL_j), and
  each level's detail contribution waiting in a block-private delay ring
  in device memory (L2-resident) until the synthesis reaches it.

:func:`transform2_plan` and :func:`denoise2_plan` derive (W, G, Tc) from the
227 KB budget, :func:`transform2_run` and :func:`denoise2_run` the run
length.  The gate admits any R and C; the transforms a halo ≤ 131 (Db4 to
L4, Symlet 8 to L3, Haar to L7), the denoise every (M, L) whose strip has
8 columns, halo ≤ 65 (Db4 to L3, Symlet 8 to L2, Haar to L6).

Beside each kernel: its plain PyTorch version (``modwt2_fwd_plain``,
``modwt2_inv_plain``, ``modwt2_denoise_plain``) and a launch count
(``modwt_cuda.LAUNCHES["<op>"]``).  Each launch is an operator
(``jwave::modwt2_fwd``, ``jwave::modwt2_inv``, ``jwave::modwt2_denoise``)
that plans its grid from the concrete batch.  bfloat16 is read and written as
bfloat16 and computed in float32.  Not differentiable: the JAX kernels have
no VJP, and the dispatch gate (``ops/modwt2d.py:_try_kernel2``) sends a
tensor that requires a gradient to the plain path.
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
    _I, _P, DTYPE_CODES, MAX_TAPS, SMEM_LIMIT, _compute_dtype, check_operand,
    check_taps, halo, host_taps, op_taps, kernel_op,
)

__all__ = [
    "modwt2_fused", "imodwt2_fused", "modwt2_denoise_fused",
    "kernel2d_supported", "modwt2_fwd_cuda", "modwt2_inv_cuda",
    "modwt2_denoise_cuda", "modwt2_fwd_plain", "modwt2_inv_plain",
    "modwt2_denoise_plain", "modwt2_fwd_op", "modwt2_inv_op",
    "modwt2_denoise_op",
]

TILE2D_MIN = 8      # narrowest strip of output columns
HALO2D_MAX = 131    # the transforms' gate: halo (M−1)(2^L − 1) ≤ 131
WARPS = 16          # JW_THREADS / 32
STEP2_GROUPS = (1, 2, 4, 8)   # rows a step: G × 16/G warps
MAX_RUNS2 = 256     # most row runs a strip is split into
KINDS2 = {"fwd": 0, "inv": 1, "denoise": 2}   # jw_modwt2_blocks' kinds


def _strip_plan(reach: int, rows_of):
    """(W, G, Tc) of a strip kernel whose block keeps ``rows_of(G)`` rows of
    W floats beside the taps and whose window reaches ``reach`` columns past
    the strip.  The 16 warps of a block take G rows of a step and 32 window
    columns each, so W ≤ 32·16/G; for each G, W is the widest window within
    that and within 227 KB, and Tc = W − reach.  Every step costs the same
    512 lanes, so the plan takes the G with the most output pixels a step,
    G·Tc.  None if no strip of ``TILE2D_MIN`` columns fits."""
    best = None
    for g in STEP2_GROUPS:
        w = min(32 * (WARPS // g), (SMEM_LIMIT // 4 - 2 * MAX_TAPS)
                // rows_of(g))
        tc = w - reach
        if tc >= TILE2D_MIN and (best is None or g * tc > best[0]):
            best = (g * tc, w, g, tc)
    return None if best is None else best[1:]


def _strip_run(strips: int, r: int, warm: int, blocks: int) -> int:
    """Rows one work item of a strip kernel marches.  A run of n rows takes
    n + ``warm`` steps' rows, and the ``blocks`` the card holds take the
    strips·⌈R/n⌉ items in waves: the run length whose waves × (n + warm) is
    least (all R where the strips fill the card evenly; shorter runs for a
    few images, or to even out the last wave)."""
    best = None
    for runs in range(1, min(r, MAX_RUNS2) + 1):
        n = -(-r // runs)
        cost = -(-strips * -(-r // n) // blocks) * (n + warm)
        if best is None or cost < best[0]:
            best = (cost, n)
    return best[1]


def transform2_smem_bytes(w: int, grp: int, level: int, m: int,
                          kind: str) -> int:
    """Dynamic shared memory of one transform block with a window of ``w``
    columns and ``grp`` rows a step (``jw2t_smem_floats``): the taps, then
    for 'fwd' G rows of row-pass pairs and one ring of (M−1)·2^(j−1) + G
    rows a level, for 'inv' G rows of (Z, LH, HL, HH) quadruples and two
    such rings a level."""
    return 4 * (2 * MAX_TAPS + w * _transform2_rows(grp, level, m, kind))


def _transform2_rows(grp: int, level: int, m: int, kind: str) -> int:
    rings = halo(m, level) + level * grp
    return 2 * grp + rings if kind == "fwd" else 4 * grp + 2 * rings


@functools.lru_cache(maxsize=None)
def transform2_plan(level: int, m: int, kind: str):
    """(W, G, Tc) of the forward ('fwd') or inverse ('inv') kernel, W = Tc + H
    (:func:`_strip_plan`).  Db4 L3: (512, 1, 463) both ways, the forward in
    111 KB (two blocks an SM), the inverse in 222 KB."""
    if level < 1 or not 1 <= m <= MAX_TAPS:
        return None
    return _strip_plan(halo(m, level),
                       lambda g: _transform2_rows(g, level, m, kind))


def transform2_strip(c: int, level: int, m: int, kind: str) -> int:
    """Output columns of each transform strip over an image of C columns:
    the plan's Tc evened out over its ⌈C/Tc⌉ strips, so the last strip is
    not mostly empty."""
    tc = transform2_plan(level, m, kind)[2]
    return -(-c // -(-c // tc))


def transform2_run(b: int, r: int, c: int, level: int, m: int, blocks: int,
                   kind: str) -> int:
    """Rows one transform work item marches: :func:`_strip_run` with a
    warm-up of H rows (the forward's reach up, the inverse's down)."""
    strips = b * -(-c // transform2_strip(c, level, m, kind))
    return _strip_run(strips, r, halo(m, level), blocks)


def denoise2_smem_bytes(w: int, grp: int, level: int, m: int) -> int:
    """Dynamic shared memory of one denoise block with a window of ``w``
    columns and ``grp`` rows a step (``jw2d_smem_floats``): the taps, five
    buffers of G rows, and four rings of (M−1)·2^(j−1) + G rows a level."""
    return 4 * (2 * MAX_TAPS + w * (5 * grp + 4 * (halo(m, level)
                                                   + level * grp)))


def denoise2_delay_rows(grp: int, level: int, m: int) -> int:
    """Rows of one denoise block's delay rings in device memory
    (``jw2d_delay_rows``): S_{j+1} + G for each level j < L, S_{j+1} the
    halo of the levels above j."""
    return sum(halo(m, level) - halo(m, j) + grp for j in range(1, level))


@functools.lru_cache(maxsize=None)
def denoise2_plan(level: int, m: int):
    """(W, G, Tc) of the denoise, W = Tc + 2H (:func:`_strip_plan`)."""
    if level < 1 or not 1 <= m <= MAX_TAPS:
        return None
    hal = halo(m, level)
    return _strip_plan(2 * hal, lambda g: 5 * g + 4 * (hal + level * g))


def denoise2_run(b: int, r: int, c: int, level: int, m: int,
                 blocks: int) -> int:
    """Rows one denoise work item marches: :func:`_strip_run` with a
    warm-up of 2H rows (the analysis's reach and the synthesis's)."""
    strips = b * -(-c // denoise2_plan(level, m)[2])
    return _strip_run(strips, r, 2 * halo(m, level), blocks)


def kernel2d_supported(r: int, c: int, level: int, m: int, kind: str) -> bool:
    """Whether 2D kernel ``kind`` ('fwd', 'inv', 'denoise') runs an R × C
    image at this level and filter length.

    The counterpart of the JAX package's ``pallas2d_supported`` /
    ``denoise2_fused_supported``: any R and C (halo larger than the image
    included); the transforms a halo (M−1)(2^L − 1) ≤ ``HALO2D_MAX`` (every
    such (M, L) has a plan, :func:`transform2_plan`), the denoise every
    (M, L) whose plan has a strip of 8 columns (:func:`denoise2_plan`).
    Db4 runs to L4 forward and inverse and to L3 denoise; Symlet 8 to L3
    and L2; Haar to L7 and L6.
    """
    if not (1 <= r < 2 ** 31 and 1 <= c < 2 ** 31 and level >= 1
            and 1 <= m <= MAX_TAPS):
        return False
    if kind == "denoise":
        return denoise2_plan(level, m) is not None
    return (halo(m, level) <= HALO2D_MAX
            and transform2_plan(level, m, kind) is not None)


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
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _P]
        fn.restype = _I
    lib.jw_modwt2_denoise.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                      _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.jw_modwt2_denoise.restype = _I
    lib.jw_modwt2_blocks.argtypes = [_I, _I, _I, _I, _I, _P]
    lib.jw_modwt2_blocks.restype = _I
    return lib


@functools.cache
def _resident_blocks(kind: str, smem: int, m: int, dtype: int,
                     device: int) -> int:
    """Blocks of 2D kernel ``kind`` the card holds at once."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    code = lib.jw_modwt2_blocks(KINDS2[kind], smem, m, dtype, device,
                                ctypes.addressof(blocks))
    _build.check(lib, code, f"2D {kind} occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the 2D {kind} kernel fits no block in "
                           f"{smem} bytes of shared memory")
    return blocks.value


def transform2_launch_plan(shape, level: int, m: int, kind: str,
                           dtype: torch.dtype, device: torch.device):
    """(W, G, Tc, run, grid) of a forward or inverse launch over (B, R, C)
    images on a CUDA ``device``: the plan's G, the even strip, the run
    length for the blocks the card holds, and a grid of at most those
    blocks (each loops over the work items)."""
    b, r, c = shape
    grp = transform2_plan(level, m, kind)[1]
    tc = transform2_strip(c, level, m, kind)
    w = tc + halo(m, level)
    blocks = _resident_blocks(
        kind, transform2_smem_bytes(w, grp, level, m, kind), m,
        DTYPE_CODES[dtype], device.index)
    run = transform2_run(b, r, c, level, m, blocks, kind)
    return w, grp, tc, run, min(b * -(-r // run) * -(-c // tc), blocks)


def _check_transform(kind: str, a: torch.Tensor, shape: tuple, level: int,
                     g, h) -> None:
    what = "2D forward" if kind == "fwd" else "2D inverse"
    if not kernel2d_supported(shape[1], shape[2], level, check_taps(g, h),
                              kind):
        raise ValueError(f"unsupported shape {tuple(shape)} level {level} "
                         f"for the {what} kernel")


def _launch_transform(kind: str, a: torch.Tensor, shape: tuple, level: int,
                      g, h) -> torch.Tensor:
    """Launch the forward or inverse kernel on ``a`` over (B, R, C) images
    of ``shape``; returns its new output."""
    m = len(g)
    what = "2D forward" if kind == "fwd" else "2D inverse"
    w, grp, tc, run, grid = transform2_launch_plan(shape, level, m, kind,
                                                   a.dtype, a.device)
    out = torch.empty((3 * level + 1,) + shape if kind == "fwd" else shape,
                      dtype=a.dtype, device=a.device)
    gh, hh = host_taps(g, h)
    lib = _lib()
    launch = lib.jw_modwt2_fwd if kind == "fwd" else lib.jw_modwt2_inv
    code = launch(a.data_ptr(), out.data_ptr(), grid, *shape, level,
                  gh.ctypes.data, hh.ctypes.data, m, w, grp, tc, run,
                  DTYPE_CODES[a.dtype], a.device.index,
                  torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, f"{what} kernel")
    return out


@kernel_op("modwt2_fwd")
def modwt2_fwd_op(x: torch.Tensor, g: list[float], h: list[float],
                  level: int) -> torch.Tensor:
    """The forward kernel's launch as an operator (``torch.ops.jwave.
    modwt2_fwd``): x (B, R, C) → (3·level+1, B, R, C).  The launch plan
    (grid, strips, row runs) is made here, from the concrete batch."""
    check_operand(x, "x", 3)
    _check_transform("fwd", x, tuple(x.shape), level, g, h)
    out = _launch_transform("fwd", x, tuple(x.shape), level, g, h)
    return out


@modwt2_fwd_op.register_fake
def _(x, g, h, level):
    check_operand(x, "x", 3, traced=True)
    _check_transform("fwd", x, tuple(x.shape), level, g, h)
    return x.new_empty((3 * level + 1,) + tuple(x.shape))


def modwt2_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """Launch the forward kernel as ``jwave::modwt2_fwd``: x (B, R, C)
    → (3·level+1, B, R, C)."""
    return modwt2_fwd_op(x, *op_taps(wavelet), level)


def _check_inv2(c: torch.Tensor, g, h, traced: bool) -> int:
    check_operand(c, "coeffs", 4, traced)
    rows = c.shape[0]
    if rows % 3 != 1:
        raise ValueError(f"coeffs: need 3·level+1 bands, got {rows}")
    level = (rows - 1) // 3
    _check_transform("inv", c, tuple(c.shape[1:]), level, g, h)
    return level


@kernel_op("modwt2_inv")
def modwt2_inv_op(c: torch.Tensor, g: list[float], h: list[float]
                  ) -> torch.Tensor:
    """The inverse kernel's launch as an operator (``torch.ops.jwave.
    modwt2_inv``): c (3·level+1, B, R, C) → (B, R, C)."""
    level = _check_inv2(c, g, h, False)
    out = _launch_transform("inv", c, tuple(c.shape[1:]), level, g, h)
    return out


@modwt2_inv_op.register_fake
def _(c, g, h):
    _check_inv2(c, g, h, True)
    return c.new_empty(tuple(c.shape[1:]))


def modwt2_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet
                    ) -> torch.Tensor:
    """Launch the inverse kernel as ``jwave::modwt2_inv``: c
    (3·level+1, B, R, C) → (B, R, C)."""
    return modwt2_inv_op(c, *op_taps(wavelet))


def _check_denoise2(x: torch.Tensor, threshold: torch.Tensor, g, h,
                    level: int, traced: bool) -> None:
    check_operand(x, "x", 3, traced)
    if (threshold.dtype != torch.float32 or threshold.ndim != 1
            or not traced and (threshold.shape[0] != x.shape[0]
                               or threshold.device != x.device
                               or not threshold.is_contiguous())):
        raise ValueError("threshold: kernel needs a contiguous (B,) float32 "
                         "tensor on x's device")
    if not kernel2d_supported(x.shape[1], x.shape[2], level,
                              check_taps(g, h), "denoise"):
        raise ValueError(f"unsupported shape {tuple(x.shape)} level {level} "
                         f"for the 2D denoise kernel")


@kernel_op("modwt2_denoise")
def modwt2_denoise_op(x: torch.Tensor, threshold: torch.Tensor,
                      g: list[float], h: list[float], level: int,
                      hard: int) -> torch.Tensor:
    """The denoise kernel's launch as an operator (``torch.ops.jwave.
    modwt2_denoise``): x (B, R, C), threshold (B,) float32 → (B, R, C);
    ``hard`` 1 for hard shrinkage, 0 for soft.  The launch plan and the
    blocks' delay rings are taken here, from the concrete batch."""
    _check_denoise2(x, threshold, g, h, level, False)
    b, r, c = x.shape
    m = len(g)
    w, grp, tc = denoise2_plan(level, m)
    dtype = DTYPE_CODES[x.dtype]
    blocks = _resident_blocks("denoise", denoise2_smem_bytes(w, grp, level, m),
                              m, dtype, x.device.index)
    run = denoise2_run(b, r, c, level, m, blocks)
    grid = min(b * -(-r // run) * -(-c // tc), blocks)
    scratch = torch.empty(
        (grid, max(1, denoise2_delay_rows(grp, level, m)), w),
        dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwt2_denoise(
        x.data_ptr(), threshold.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), grid, b, r, c, level, gh.ctypes.data,
        hh.ctypes.data, m, w, grp, tc, run, int(hard), dtype,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "2D denoise kernel")
    return out


@modwt2_denoise_op.register_fake
def _(x, threshold, g, h, level, hard):
    _check_denoise2(x, threshold, g, h, level, True)
    return torch.empty_like(x)


def modwt2_denoise_cuda(x: torch.Tensor, threshold: torch.Tensor,
                        wavelet: DiscreteWavelet, level: int,
                        mode: str = "soft") -> torch.Tensor:
    """Launch the denoise kernel as ``jwave::modwt2_denoise``: x
    (B, R, C), threshold (B,) float32 → (B, R, C)."""
    return modwt2_denoise_op(x, threshold, *op_taps(wavelet), level,
                             int(mode != "soft"))


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
