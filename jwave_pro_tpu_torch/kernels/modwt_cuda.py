"""Fused multi-level MODWT kernels for the H100 (``csrc/modwt.cu``).

Replaces ``jwave_pro_tpu/kernels/modwt_pallas.py``:

* ``jw_modwt_fwd_kernel`` ← ``_forward_kernel`` (``:204``) and
  ``_forward_kernel_flat`` (``:286``).  The flat variant exists only for the
  TPU's sublane layout; here a 1D ``(N,)`` input is B = 1 of the batched
  kernel, and ``(L+1, 1, N) → (L+1, N)`` is a free view.
* ``jw_modwt_inv_kernel`` ← ``_inverse_kernel`` (``:564``).

What bounds them on the H100 is device-memory traffic: the forward moves
1 read + (L+1) writes per sample against 4·M·L flops, the inverse the
mirror image.  Each block keeps one tile's whole level chain in shared
memory and reads its circular context ``x[(p) mod N]`` directly, so any N
runs without padding, folding or a tile plan; the only limit is the
shared-memory budget (:func:`kernel_supported`).  Both are templated on
the filter length (taps as parameter-bank operands) and compute each
level in register chains of ``CHAIN[kind]`` outputs a thread.  The
forward stages each warp's W outputs in shared memory so that its stores,
L + 1 rows for each row read, stay coalesced; the inverse has the next
level's W row in flight while a level runs.

The inverse has a second instantiation for the denoise
(``jw_modwt_inv_shrink_kernel``, its entry point in
``csrc/modwt_shrink.cu``, operator ``jwave::modwt_inv_shrink``): every
detail row is shrunk by the soft or hard rule as the kernel loads it, so
``ops/denoise.py:modwt_denoise`` reads the forward's coefficients as they
lie, with no shrunk copy and no stack of them.

The forward has a second instantiation for one shard of a longer signal
(``jw_modwt_fwd_ctx_kernel``, operator ``jwave::modwt_fwd_ctx``): the
halo samples before each row's position 0 come from a (rows, halo)
context operand, the left neighbour's last samples, in place of the
row's own wrapped end.  ``parallel/sharded.py:modwt_sharded`` fetches
that context in one ring hop and makes one launch.

Beside each kernel: its plain PyTorch version (``modwt_fwd_plain``,
``modwt_fwd_ctx_plain``, ``modwt_inv_plain``, ``modwt_inv_shrink_plain``),
which the CPU path runs and the chip smoke compares against, and a launch
count (``_launch.LAUNCHES["modwt_fwd"]`` and the others).  Each launch
is a ``torch.library`` operator (``jwave::modwt_fwd``,
``jwave::modwt_inv``, :func:`_launch.kernel_op`) whose taps travel as float
lists (:func:`_launch.op_taps`) and whose grid is planned at launch, so a
batch-polymorphic ``torch.export`` records the launch and the served graph
runs the kernel; its fake gives the output's shape.  The 1D kernels'
shared-memory plan lives here too (:func:`kernel_plan`, computed once a
kind, level and filter length), which the packet, variance and denoise
kernels share.  bfloat16 tensors are read and written as bfloat16 and
computed in float32, in the kernels and their plain versions alike.  The
autograd pair (:class:`ModwtFused`, :class:`ImodwtFused`, checked by
:func:`modwt_fused` and :func:`imodwt_fused`) rests on Aᵀ = A⁻¹ for the
analysis operator A: each direction's backward is the other kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.modwt import (
    _check_level, _combined_adjoint, _conv_channels, modwt_base_filters,
    taps_as,
)
from ..wavelets.base import DiscreteWavelet
from ._launch import (
    DTYPE_CODES, MAX_TAPS, SMEM_LIMIT, check_grid, check_operand, check_taps,
    compute_dtype, host_taps, kernel_op, launch, op_taps,
)

__all__ = [
    "modwt_fused", "imodwt_fused", "ModwtFused", "ImodwtFused",
    "kernel_supported", "kernel_plan", "KernelPlan", "require_plan", "check_fused",
    "modwt_fwd_cuda", "modwt_inv_cuda", "modwt_fwd_plain", "modwt_inv_plain",
    "modwt_fwd_ctx_cuda", "modwt_fwd_ctx_plain", "modwt_shard",
    "modwt_inv_shrink_cuda", "modwt_inv_shrink_plain", "cut_plain",
    "modwt_fwd_op", "modwt_fwd_ctx_op", "modwt_inv_op", "modwt_inv_shrink_op",
]

WARPS = 512 // 32             # JW_THREADS / 32 in csrc/common.cuh
# outputs per block; the packet kernels ('pfwd', 'select', 'pinv') keep
# 2L - 1 or 2L window rows, hence the smaller tile of two (the select's and
# both forwards' are cut where their rows do not fit: :func:`tile_of`)
TILES = {"fwd": 4096, "inv": 4096, "denoise": 2048, "var": 4096,
         "pfwd": 2048, "select": 4096, "pinv": 2048}
# outputs in one thread's register chain: JW_VAR_R (csrc/variance.cu),
# JW_SELECT_R, JW_PFWD_R and JW_PINV_R (csrc/modwpt.cu), JW_FWD_R and
# JW_INV_R (csrc/modwt.cu) and JW_DENOISE_R (csrc/denoise.cu, both its
# analysis and its synthesis chains); odd, so a warp's loads hit 32 banks
CHAIN = {"var": 9, "select": 5, "fwd": 9, "inv": 7, "denoise": 5,
         "pfwd": 5, "pinv": 5}
FWD_THREADS = 256             # JW_FWD_THREADS in csrc/modwt.cu
PFWD_THREADS = 256            # JW_PFWD_THREADS in csrc/modwpt.cu
# the forwards' output staging, floats a block: a slice of 32 chains'
# outputs a warp, W_j for 'fwd' (JW_FWD_SLICE), both leaves for 'pfwd'
# (JW_PFWD_SLICE)
FWD_SLICE = FWD_THREADS * CHAIN["fwd"]
PFWD_SLICE = PFWD_THREADS * 2 * CHAIN["pfwd"]
SLICES = {"fwd": FWD_SLICE, "pfwd": PFWD_SLICE}
# the slice is paid for out of the forward's tile, not its halo: the tile is
# cut to what the slice leaves of the budget (:func:`tile_of`), and a shape
# runs only where that leaves this much, i.e. where its halo fits beside a
# full tile in two rows without the slice
FWD_MIN_TILE = TILES["fwd"] - FWD_SLICE // 2


def halo(m: int, level: int) -> int:
    """Exact context one output needs: (M−1)(2^L − 1) samples."""
    return (m - 1) * ((1 << level) - 1)


def _rows(kind: str, level: int) -> int:
    """Window rows of the packet kernels' depth-first walk: 2L − 1 for the
    forward and the select, 2L for the inverse (three at L = 1, where the
    root needs a row of its own)."""
    return {"pfwd": 2 * level - 1, "select": 2 * level - 1,
            "pinv": max(2 * level, 3)}[kind]


def tile_of(kind: str, level: int, m: int) -> int:
    """Outputs per block of kernel ``kind``: ``TILES[kind]``, the select's
    and both forwards' cut to what their rows (2L − 1 for the select and
    the packet forward, two for the MODWT forward, the forwards' beside
    their staging slices) leave of the shared-memory budget (below 1 where
    even the halo does not fit)."""
    free = SMEM_LIMIT // 4 - 2 * MAX_TAPS
    if kind == "select":
        fit = (free - 8 * WARPS) // _rows(kind, level) - halo(m, level)
    elif kind == "pfwd":
        fit = (free - PFWD_SLICE) // _rows(kind, level) - halo(m, level)
    elif kind == "fwd":
        fit = (free - FWD_SLICE) // 2 - halo(m, level)
    else:
        return TILES[kind]
    return min(TILES[kind], fit)


def smem_bytes(level: int, m: int, kind: str, tile: int | None = None,
               slice_floats: int | None = None) -> int:
    """Dynamic shared memory of one block: the taps plus the window rows
    (two V buffers for 'fwd', with one W staging slice a warp; for 'var'
    two V buffers, with one warp sum a warp
    and level; two V and one W for 'inv'; two V and L W rows over a
    two-sided window for 'denoise'; the depth-first packet path's 2L − 1
    rows for 'pfwd', with one slice of both leaves a warp, and for
    'select', which adds two sets of two leaves' 64-bit arg-max keys per
    warp; 2L rows for 'pinv', three at L = 1).  ``tile`` (default
    :func:`tile_of`) and ``slice_floats`` (floats of a forward's staging
    slices, default ``SLICES[kind]``) lay out another plan, as a probe's
    variant of a kernel runs it."""
    h, t = halo(m, level), tile or tile_of(kind, level, m)
    sl = SLICES.get(kind, 0) if slice_floats is None else slice_floats
    rows = {"fwd": sl + 2 * (t + h), "inv": 3 * (t + h),
            "denoise": (level + 2) * (t + 2 * h),
            "var": 2 * (t + h) + WARPS * (level + 1),
            "pfwd": sl + _rows("pfwd", level) * (t + h),
            "select": _rows("select", level) * (t + h) + 8 * WARPS,
            "pinv": _rows("pinv", level) * (t + h)}[kind]
    return 4 * (2 * MAX_TAPS + rows)


class KernelPlan(NamedTuple):
    """One block of 1D kernel ``kind`` at a level and filter length:
    ``tile`` outputs, the ``halo`` of context, ``smem`` bytes of dynamic
    shared memory (:func:`tile_of`, :func:`halo`, :func:`smem_bytes`)."""
    tile: int
    halo: int
    smem: int


def kernel_plan(kind: str, level: int, m: int) -> KernelPlan | None:
    """Kernel ``kind``'s plan at this level and filter length, computed
    once; None where it does not run (:func:`kernel_supported`).  A
    symbolic level (an operator's fake under a dynamic-shape trace) keys
    no cache: its plan is computed each time."""
    plan = _plan if isinstance(level, int) else _plan.__wrapped__
    return plan(kind, level, m)


@functools.lru_cache(maxsize=1024)
def _plan(kind: str, level: int, m: int) -> KernelPlan | None:
    if not (level >= 1 and 1 <= m <= MAX_TAPS):
        return None
    h = halo(m, level)
    if kind in ("pfwd", "pinv"):
        rows = 2 * level - (kind == "pfwd")
        if 4 * (2 * MAX_TAPS + rows * (TILES[kind] + h)) > SMEM_LIMIT:
            return None
    tile = tile_of(kind, level, m)
    if tile < (FWD_MIN_TILE if kind == "fwd" else 1):
        return None
    smem = smem_bytes(level, m, kind, tile)
    return KernelPlan(tile, h, smem) if smem <= SMEM_LIMIT else None


def kernel_supported(n: int, level: int, m: int, kind: str) -> bool:
    """Whether kernel ``kind`` runs this shape: 'fwd', 'inv', 'denoise',
    'var' (MODWT), 'pfwd', 'select', 'pinv' (MODWPT).

    The counterpart of the JAX package's ``pallas_supported`` family,
    re-derived from the 227 KB shared-memory budget of a block: any N runs,
    the halo must fit (Db4 runs to L=11 forward and variance, L=8 denoise,
    packet forward and select, L=7 packet inverse; Db4 L13's 57,337-sample
    halo does not fit).  The forwards' staging slices come out of their
    tiles, not their gates: 'fwd' runs where its halo fits beside a
    ``FWD_MIN_TILE`` tile, and 'pfwd' and 'pinv' where their 2L − 1 and 2L
    rows fit at the full 2048-sample tile.  Reads :func:`kernel_plan`.
    """
    return 1 <= n < 2 ** 31 and kernel_plan(kind, level, m) is not None


def require_plan(kind: str, n: int, level: int, m: int, shape,
                 what: str) -> KernelPlan:
    """:func:`kernel_plan` of a shape :func:`kernel_supported` admits;
    raise for any other, naming the ``what`` kernel."""
    plan = kernel_plan(kind, level, m)
    if plan is None or not 1 <= n < 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(shape)} level {level} "
                         f"for the {what} kernel")
    return plan


class TilePlan(NamedTuple):
    """Launch geometry of a kernel that finishes its reduction over a row's
    tiles inside the launch ('var', 'select'): ``tile`` outputs a block,
    ``ntiles`` tiles a row, ``grid`` blocks (B × ntiles), ``smem`` bytes of
    shared memory a block, ``chain`` outputs in a thread's register chain."""
    tile: int
    ntiles: int
    grid: int
    smem: int
    chain: int


@functools.lru_cache(maxsize=256)
def tile_plan(kind: str, batch: int, n: int, level: int, m: int
              ) -> TilePlan:
    """Kernel ``kind``'s launch for (B, N) at this level and filter length
    (:func:`kernel_plan`); raises where :func:`kernel_supported` rejects the
    shape."""
    plan = require_plan(kind, n, level, m, (batch, n), f"'{kind}'")
    check_grid(batch, n, plan.tile)
    ntiles = -(-n // plan.tile)
    return TilePlan(plan.tile, ntiles, batch * ntiles, plan.smem, CHAIN[kind])


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def modwt_fwd_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: ``(..., N)`` →
    ``(level+1, ..., N)``, computed in float32 (float64 for float64 input)
    and returned in ``x``'s dtype."""
    cdt = compute_dtype(x.dtype)
    g, h = (taps_as(f, cdt) for f in modwt_base_filters(wavelet))
    v = x.to(cdt)
    rows = []
    for j in range(1, level + 1):
        out = _conv_channels(v, (g, h), 1 << (j - 1), adjoint=False)
        rows.append(out[..., 1, :])
        v = out[..., 0, :]
    rows.append(v)
    return torch.stack(rows).to(x.dtype)


def _fir(v: torch.Tensor, f, d: int, start: int, size: int,
         into: torch.Tensor | None = None) -> torch.Tensor:
    """y[t] = Σ_k f[k]·v[start + t − k·d] for t < ``size``, no wrap
    (``start`` ≥ (len(f) − 1)·d), accumulated in place in ``into`` (a new
    tensor when None)."""
    for k, c in enumerate(f):
        part = v[..., start - k * d:start - k * d + size]
        if k:
            into.add_(part, alpha=c)
        elif into is None:
            into = c * part
        else:
            into.copy_(part).mul_(c)
    return into


def modwt_fwd_ctx_plain(x: torch.Tensor, ctx: torch.Tensor,
                        wavelet: DiscreteWavelet, level: int) -> torch.Tensor:
    """The context variant's function in plain PyTorch: the forward of a
    shard ``x`` (..., n) whose ``halo(M, level)`` samples before position
    0 are ``ctx`` (..., halo) → (level+1, ..., n), x's dtype.

    The level cascade runs on [ctx | x] without wrapping: level j's
    outputs need (M−1)·2^(j−1) samples before them, so each V_j is kept
    only where it is valid, and W_j and V_L only over the shard, each
    written once into the output as it is computed (no list, no stack).
    Computed in float32 (float64 for float64 input, the input's own
    dtype for complex input); differentiable."""
    m, n = wavelet.length, x.shape[-1]
    if ctx.shape[-1] != halo(m, level) or ctx.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"context {tuple(ctx.shape)} for a shard "
                         f"{tuple(x.shape)} at level {level}: need "
                         f"(..., {halo(m, level)})")
    cdt = x.dtype if x.is_complex() else compute_dtype(x.dtype)
    g, h = (taps_as(f, cdt.to_real()) for f in modwt_base_filters(wavelet))
    v = torch.cat([ctx.to(cdt), x.to(cdt)], dim=-1)
    out = x.new_empty((level + 1,) + tuple(x.shape))
    direct = out.dtype == cdt
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        first = v.shape[-1] - n       # the shard's first sample in v
        # W_j, and at the last level V_L, over the shard's n samples
        rows = ((h, j - 1), (g, level)) if j == level else ((h, j - 1),)
        for f, row in rows:
            if direct:
                _fir(v, f, d, first, n, out[row])
            else:
                out[row].copy_(_fir(v, f, d, first, n))
        if j < level:
            span = (m - 1) * d
            v = _fir(v, g, d, span, v.shape[-1] - span)
    return out


def modwt_inv_plain(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """The inverse kernel's function in plain PyTorch: ``(level+1, ..., N)``
    → ``(..., N)``, computed like :func:`modwt_fwd_plain`."""
    cdt = compute_dtype(c.dtype)
    g, h = (taps_as(f, cdt) for f in modwt_base_filters(wavelet))
    level = c.shape[0] - 1
    v = c[level].to(cdt)
    for j in range(level, 0, -1):
        v = _combined_adjoint(v, c[j - 1].to(cdt), g, h, 1 << (j - 1))
    return v.to(c.dtype)


def modwt_inv_shrink_plain(c: torch.Tensor, thr: torch.Tensor | None,
                           value: float, wavelet: DiscreteWavelet,
                           hard: int = 0) -> torch.Tensor:
    """The shrinking inverse's function in plain PyTorch: c (level+1, B,
    N) → (B, N), c's dtype, each detail row W_j = c[j − 1] shrunk by its
    threshold for row b, ``thr[j − 1, b]`` (thr (level, B) of c's dtype),
    or the float32 ``value`` for every row where ``thr`` is None, then
    :func:`modwt_inv_plain`.

    The shrink as the kernel computes it: :func:`cut_plain`."""
    level = c.shape[0] - 1
    t = (torch.tensor(value, dtype=torch.float32) if thr is None
         else thr.to(torch.float32)[..., None])
    return modwt_inv_plain(torch.cat([cut_plain(c[:level], t, hard),
                                      c[level:]]), wavelet)


def cut_plain(w: torch.Tensor, t: torch.Tensor, hard: int) -> torch.Tensor:
    """The detail values ``w`` shrunk by the thresholds ``t`` (float32,
    broadcasting against ``w``) as the shrinking inverses (#3s, #10s)
    compute it, in float32: soft sign(w)·max(|w| − t, 0) with NaN passed
    on and the difference rounded to w's dtype first (as torch's bfloat16
    subtraction rounds it), hard w·1[|w| > t]; returned in w's dtype."""
    v = w.to(torch.float32)
    if hard:
        shrunk = torch.where(v.abs() > t, v, 0.0)
    else:
        a = (v.abs() - t).to(w.dtype).to(torch.float32)
        shrunk = torch.sign(v) * torch.clamp_min(a, 0.0)
    return shrunk.to(w.dtype)


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_fwd(x: torch.Tensor, g, h, level: int,
               traced: bool = True) -> KernelPlan:
    check_operand(x, "x", 2, traced)
    return require_plan("fwd", x.shape[1], level, check_taps(g, h), x.shape,
                        "MODWT forward")


@kernel_op("modwt_fwd")
def modwt_fwd_op(x: torch.Tensor, g: list[float], h: list[float],
                 level: int) -> torch.Tensor:
    """The forward kernel's launch as an operator (``torch.ops.jwave.
    modwt_fwd``): x (B, N) → (level+1, B, N), x's dtype.  The grid is
    planned here, from the concrete batch."""
    plan = _check_fwd(x, g, h, level, traced=False)
    b, n = x.shape
    check_grid(b, n, plan.tile)
    out = torch.empty((level + 1, b, n), dtype=x.dtype, device=x.device)
    gh, hh = host_taps(g, h)
    launch("jw_modwt_fwd", "modwt forward kernel", x.device, x.data_ptr(),
           out.data_ptr(), b, n, level, gh.ctypes.data, hh.ctypes.data,
           len(g), *plan, DTYPE_CODES[x.dtype])
    return out


@modwt_fwd_op.register_fake
def _(x, g, h, level):
    _check_fwd(x, g, h, level)
    return x.new_empty((level + 1,) + tuple(x.shape))


def modwt_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                   level: int) -> torch.Tensor:
    """Launch the forward kernel as ``jwave::modwt_fwd``: x (B, N) →
    (level+1, B, N), x's dtype."""
    return modwt_fwd_op(x, *op_taps(wavelet), level)


def _check_fwd_ctx(x: torch.Tensor, ctx: torch.Tensor, g, h, level: int,
                   traced: bool = True) -> KernelPlan:
    plan = _check_fwd(x, g, h, level, traced)
    check_operand(ctx, "ctx", 2, traced)
    want = (x.shape[0], plan.halo)
    if tuple(ctx.shape) != want or ctx.dtype != x.dtype:
        raise ValueError(f"ctx: expected {x.dtype} {want}, got {ctx.dtype} "
                         f"{tuple(ctx.shape)}")
    return plan


@kernel_op("modwt_fwd_ctx")
def modwt_fwd_ctx_op(x: torch.Tensor, ctx: torch.Tensor, g: list[float],
                     h: list[float], level: int) -> torch.Tensor:
    """The context variant's launch as an operator (``torch.ops.jwave.
    modwt_fwd_ctx``): a shard x (B, n) and the halo samples before each
    row's position 0, ctx (B, halo(M, level)) → (level+1, B, n), x's
    dtype.  The plan is the forward's."""
    plan = _check_fwd_ctx(x, ctx, g, h, level, traced=False)
    b, n = x.shape
    check_grid(b, n, plan.tile)
    out = torch.empty((level + 1, b, n), dtype=x.dtype, device=x.device)
    gh, hh = host_taps(g, h)
    launch("jw_modwt_fwd_ctx", "modwt forward kernel with context", x.device,
           x.data_ptr(), ctx.data_ptr(), out.data_ptr(), b, n, level,
           gh.ctypes.data, hh.ctypes.data, len(g), *plan,
           DTYPE_CODES[x.dtype])
    return out


@modwt_fwd_ctx_op.register_fake
def _(x, ctx, g, h, level):
    _check_fwd_ctx(x, ctx, g, h, level)
    return x.new_empty((level + 1,) + tuple(x.shape))


def modwt_fwd_ctx_cuda(x: torch.Tensor, ctx: torch.Tensor,
                       wavelet: DiscreteWavelet, level: int) -> torch.Tensor:
    """Launch the context variant as ``jwave::modwt_fwd_ctx``: x (B, n),
    ctx (B, halo) → (level+1, B, n), x's dtype."""
    return modwt_fwd_ctx_op(x, ctx, *op_taps(wavelet), level)


def modwt_shard(x: torch.Tensor, ctx: torch.Tensor, wavelet: DiscreteWavelet,
                level: int) -> torch.Tensor:
    """The forward of a shard ``x`` (..., n) given the ``halo(M, level)``
    samples before its position 0, ``ctx`` (..., halo): (level+1, ..., n).

    One launch of the context variant for a CUDA float32/bfloat16 shard
    whose shape the kernel takes (:func:`kernel_supported`) and that needs
    no gradient; :func:`modwt_fwd_ctx_plain` otherwise."""
    n = x.shape[-1]
    grad = torch.is_grad_enabled() and (x.requires_grad or ctx.requires_grad)
    if (x.is_cuda and x.dtype in DTYPE_CODES and ctx.dtype == x.dtype
            and not grad
            and kernel_supported(n, level, wavelet.length, "fwd")):
        rows = x.reshape(-1, n).contiguous()
        out = modwt_fwd_ctx_cuda(rows, ctx.reshape(rows.shape[0], -1)
                                 .contiguous(), wavelet, level)
        return out.reshape((level + 1,) + tuple(x.shape))
    return modwt_fwd_ctx_plain(x, ctx, wavelet, level)


def _check_inv(c: torch.Tensor, g, h, traced: bool = True) -> KernelPlan:
    check_operand(c, "coeffs", 3, traced)
    return require_plan("inv", c.shape[2], c.shape[0] - 1, check_taps(g, h),
                        c.shape, "MODWT inverse")


@kernel_op("modwt_inv")
def modwt_inv_op(c: torch.Tensor, g: list[float], h: list[float]
                 ) -> torch.Tensor:
    """The inverse kernel's launch as an operator (``torch.ops.jwave.
    modwt_inv``): c (level+1, B, N) → (B, N), c's dtype."""
    plan = _check_inv(c, g, h, traced=False)
    rows, b, n = c.shape
    check_grid(b, n, plan.tile)
    out = torch.empty((b, n), dtype=c.dtype, device=c.device)
    gh, hh = host_taps(g, h)
    launch("jw_modwt_inv", "modwt inverse kernel", c.device, c.data_ptr(),
           out.data_ptr(), b, n, rows - 1, gh.ctypes.data, hh.ctypes.data,
           len(g), *plan, DTYPE_CODES[c.dtype])
    return out


@modwt_inv_op.register_fake
def _(c, g, h):
    _check_inv(c, g, h)
    return c.new_empty(tuple(c.shape[1:]))


def modwt_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Launch the inverse kernel as ``jwave::modwt_inv``: c (level+1,
    B, N) → (B, N), c's dtype."""
    return modwt_inv_op(c, *op_taps(wavelet))


def _check_inv_shrink(c: torch.Tensor, thr: torch.Tensor | None, g, h,
                      traced: bool = True) -> KernelPlan:
    plan = _check_inv(c, g, h, traced)
    if thr is not None and (
            thr.dtype != c.dtype or thr.ndim != 2
            or not traced and (tuple(thr.shape) != (c.shape[0] - 1,
                                                    c.shape[1])
                               or thr.device != c.device)):
        raise ValueError(f"threshold: kernel needs a (level, B) tensor of "
                         f"the coefficients' dtype on their device, got "
                         f"{thr.dtype} {tuple(thr.shape)}")
    return plan


@kernel_op("modwt_inv_shrink")
def modwt_inv_shrink_op(c: torch.Tensor, thr: torch.Tensor | None,
                        value: float, g: list[float], h: list[float],
                        hard: int) -> torch.Tensor:
    """The shrinking inverse's launch as an operator (``torch.ops.jwave.
    modwt_inv_shrink``): c (level+1, B, N) → (B, N), c's dtype, every
    detail row W_j shrunk as the kernel loads it by ``thr[j − 1, b]`` (thr
    (level, B) of c's dtype, any strides: a broadcast view is read as it
    lies), or by ``value`` (as float32) for every row where ``thr`` is
    None; ``hard`` 1 for hard shrinkage, 0 for soft.  The plan is the
    inverse's."""
    plan = _check_inv_shrink(c, thr, g, h, traced=False)
    rows, b, n = c.shape
    check_grid(b, n, plan.tile)
    out = torch.empty((b, n), dtype=c.dtype, device=c.device)
    ls, rs = (0, 0) if thr is None else thr.stride()
    gh, hh = host_taps(g, h)
    launch("jw_modwt_inv_shrink", "modwt shrinking inverse kernel", c.device,
           c.data_ptr(), None if thr is None else thr.data_ptr(), value, ls,
           rs, hard, out.data_ptr(), b, n, rows - 1, gh.ctypes.data,
           hh.ctypes.data, len(g), *plan, DTYPE_CODES[c.dtype])
    return out


@modwt_inv_shrink_op.register_fake
def _(c, thr, value, g, h, hard):
    _check_inv_shrink(c, thr, g, h)
    return c.new_empty(tuple(c.shape[1:]))


def modwt_inv_shrink_cuda(c: torch.Tensor, thr: torch.Tensor | None,
                          value: float, wavelet: DiscreteWavelet,
                          hard: int = 0) -> torch.Tensor:
    """Launch the shrinking inverse as ``jwave::modwt_inv_shrink``: c
    (level+1, B, N), thr (level, B) or None → (B, N), c's dtype."""
    return modwt_inv_shrink_op(c, thr, value, *op_taps(wavelet), hard)


# ---------------------------------------------------------------------------
# The autograd pair, and its checked entries
# ---------------------------------------------------------------------------

def _fwd(x: torch.Tensor, wavelet: DiscreteWavelet,
         level: int) -> torch.Tensor:
    if not x.is_cuda:
        return modwt_fwd_plain(x, wavelet, level)
    out = modwt_fwd_cuda(x.contiguous().reshape(-1, x.shape[-1]), wavelet,
                         level)
    return out.reshape((level + 1,) + tuple(x.shape))


def _inv(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    if not c.is_cuda:
        return modwt_inv_plain(c, wavelet)
    out = modwt_inv_cuda(c.contiguous().reshape(c.shape[0], -1, c.shape[-1]),
                         wavelet)
    return out.reshape(tuple(c.shape[1:]))


class ModwtFused(torch.autograd.Function):
    """The forward kernel (the plain version off the card) with the inverse
    as its backward, unchecked: for a caller that has checked the shape,
    as :func:`modwt_fused` and ``ops/modwt.py:_try_kernel`` do."""
    @staticmethod
    def forward(ctx, x, wavelet, level):
        ctx.wavelet = wavelet
        return _fwd(x, wavelet, level)

    @staticmethod
    def backward(ctx, cot):
        return _inv(cot, ctx.wavelet), None, None


class ImodwtFused(torch.autograd.Function):
    """The inverse kernel with the forward as its backward, unchecked, as
    :class:`ModwtFused`."""
    @staticmethod
    def forward(ctx, c, wavelet):
        ctx.wavelet, ctx.level = wavelet, c.shape[0] - 1
        return _inv(c, wavelet)

    @staticmethod
    def backward(ctx, cot):
        return _fwd(cot, ctx.wavelet, ctx.level), None


def check_fused(a: torch.Tensor, kind: str, level: int, m: int,
                what: str) -> None:
    """The 1D ``*_fused`` functions' check of a CUDA or CPU tensor ``a``
    (..., N) for kernel ``kind``: raise naming ``what`` where the kernel
    does not run."""
    require_plan(kind, a.shape[-1], level, m, a.shape, what)
    if not (a.is_cuda or a.device.type == "cpu"):
        raise ValueError(f"no {what} kernel for device {a.device}")


def modwt_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                level: int) -> torch.Tensor:
    """Fused forward MODWT: x (B, N) → (level+1, B, N), (N,) → (level+1, N);
    differentiable (the backward is the inverse kernel).

    A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
    version.  Raises for shapes :func:`kernel_supported` rejects.
    """
    if x.ndim not in (1, 2):
        raise ValueError(f"fused MODWT takes (N,) or (B, N), got "
                         f"{tuple(x.shape)}")
    _check_level(x.shape[-1], level)
    check_fused(x, "fwd", level, wavelet.length, "fused MODWT")
    return ModwtFused.apply(x, wavelet, level)


def imodwt_fused(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Fused inverse MODWT: (level+1, B, N) → (B, N), (level+1, N) → (N,);
    differentiable (the backward is the forward kernel)."""
    if c.ndim not in (2, 3):
        raise ValueError(f"fused iMODWT takes (L+1, N) or (L+1, B, N), got "
                         f"{tuple(c.shape)}")
    check_fused(c, "inv", c.shape[0] - 1, wavelet.length, "fused iMODWT")
    return ImodwtFused.apply(c, wavelet)
