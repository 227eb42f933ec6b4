"""Fused MODWPT (packet tree) kernels for the H100 (``csrc/modwpt.cu``).

Replaces ``jwave_pro_tpu/kernels/modwpt_pallas.py``:

* ``jw_modwpt_fwd_kernel`` ← ``_forward_kernel`` (``:128``): x (B, N) →
  all 2^L leaves ``(2^L, B, N)`` in sequency order ``n ^ ((n>>1)&1)``.
* ``jw_modwpt_select_kernel`` ← ``_select_kernel`` (``:264``): the same
  cascade with a per-node arg-max of |w| in place of the stores —
  ``(absmax, shift, value)``, each ``(2^L, B)``; the ``(2^L, B, N)`` block is
  never written.  Each block writes its tile's best per node, and the
  row's last block to finish (an atomic ticket, :func:`tickets`) merges the
  tiles inside the same launch, as the TPU kernel kept a running max across
  its sequential tile axis.  Every merge takes the larger |w|, then the
  smaller position, so the result is the arg-max over the whole
  coefficient row (its first maximum) whatever order the blocks ran in.
  It computes each node with the forward kernel's arithmetic, in register
  chains of ``modwt_cuda.CHAIN['select']`` outputs a thread
  (:func:`select_plan`).
* ``jw_modwpt_inv_kernel`` ← ``_inverse_kernel`` (``:468``): the adjoint.

Each block walks its tile's tree depth-first, so its shared memory grows
with L (2L − 1 rows forward, 2L inverse) rather than with 2^L; any N runs,
halo longer than N included (:func:`kernels.modwt_cuda.kernel_supported`,
kinds 'pfwd', 'select', 'pinv').  All three compute in register chains
with the taps as parameter-bank operands (``modwt_cuda.CHAIN``); the
forward stages each warp's leaves in shared memory so that its stores,
2^L rows for each row read, stay coalesced, and the inverse loads each
leaf pair with batched loads.

Beside each kernel: its plain PyTorch version (``modwpt_fwd_plain``,
``modwpt_inv_plain``, ``modwpt_select_plain``) and a launch counter
(``<launcher>.launches``).  Each launch is an operator
(``jwave::modwpt_fwd``, ``jwave::modwpt_select``, ``jwave::modwpt_inv``).
bfloat16 is read and written as bfloat16 and computed in float32; the select
returns float32.  The autograd pair (:func:`modwpt_fused`,
:func:`imodwpt_fused`) rests on Aᵀ = A⁻¹: every level applies the same
√2-normalized perfect-reconstruction pair to each node and the sequency
reorder is a permutation, so each direction's backward is the other kernel.
"""
from __future__ import annotations

import functools

import torch

from ..ops.modwpt import _level_forward, _level_inverse
from ..ops.modwt import _check_level, modwt_base_filters
from ..wavelets.base import DiscreteWavelet
from . import _build
from .modwt_cuda import (
    _I, _P, DTYPE_CODES, TilePlan, _compute_dtype, check_grid, check_operand,
    check_taps, halo, host_taps, kernel_supported, op_taps, smem_bytes,
    tickets, tile_of, tile_plan, kernel_op,
)

__all__ = [
    "modwpt_fused", "imodwpt_fused", "modwpt_select_fused",
    "select_fused_supported", "modwpt_fwd_cuda", "modwpt_inv_cuda",
    "modwpt_select_cuda", "modwpt_fwd_plain", "modwpt_inv_plain",
    "modwpt_select_plain", "select_plan", "modwpt_fwd_op", "modwpt_inv_op",
    "modwpt_select_op",
]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def modwpt_fwd_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                     level: int) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: ``(..., N)`` →
    ``(2^level, ..., N)``, computed in float32 (float64 for float64 input)
    and returned in ``x``'s dtype."""
    g, h = modwt_base_filters(wavelet)
    nodes = x.to(_compute_dtype(x.dtype))[None]
    for j in range(1, level + 1):
        nodes = _level_forward(nodes, g, h, j, "direct")
    return nodes.to(x.dtype)


def modwpt_inv_plain(c: torch.Tensor, wavelet: DiscreteWavelet
                     ) -> torch.Tensor:
    """The inverse kernel's function in plain PyTorch: ``(2^level, ..., N)``
    → ``(..., N)``, computed like :func:`modwpt_fwd_plain`."""
    g, h = modwt_base_filters(wavelet)
    nodes = c.to(_compute_dtype(c.dtype))
    for j in range(c.shape[0].bit_length() - 1, 0, -1):
        nodes = _level_inverse(nodes, g, h, j, "direct")
    return nodes[0].to(c.dtype)


def modwpt_select_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                        level: int):
    """The select kernel's function in plain PyTorch: x (B, N) →
    ``(absmax, shift, value)``, each ``(2^level, B)``: per node the largest
    |w| (float32; float64 for float64 input), its first position (int32) and
    the signed coefficient there."""
    c = modwpt_fwd_plain(x.to(_compute_dtype(x.dtype)), wavelet, level)
    shift = torch.argmax(torch.abs(c), dim=-1, keepdim=True)
    value = torch.gather(c, -1, shift)[..., 0]
    return torch.abs(value), shift[..., 0].to(torch.int32), value


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    lib = _build.library()
    for fn in (lib.jw_modwpt_fwd, lib.jw_modwpt_inv):
        fn.argtypes = [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    lib.jw_modwpt_select.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I,
                                     _I, _I, _I, _I, _P]
    lib.jw_modwpt_select.restype = _I
    return lib


def _require(n: int, level: int, m: int, kind: str, shape,
             what: str) -> None:
    if not kernel_supported(n, level, m, kind):
        raise ValueError(f"unsupported shape {tuple(shape)} level {level} "
                         f"for the {what} kernel")


def _check_pfwd(x: torch.Tensor, g, h, level: int, kind: str,
                what: str, traced: bool = True) -> None:
    check_operand(x, "x", 2, traced)
    _require(x.shape[1], level, check_taps(g, h), kind, x.shape, what)


@kernel_op("modwpt_fwd")
def modwpt_fwd_op(x: torch.Tensor, g: list[float], h: list[float],
                  level: int) -> torch.Tensor:
    """The forward kernel's launch as an operator (``torch.ops.jwave.
    modwpt_fwd``): x (B, N) → (2^level, B, N), x's dtype."""
    _check_pfwd(x, g, h, level, "pfwd", "MODWPT forward", traced=False)
    b, n = x.shape
    m = len(g)
    tile = tile_of("pfwd", level, m)
    check_grid(b, n, "pfwd", tile)
    out = torch.empty((1 << level, b, n), dtype=x.dtype, device=x.device)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwpt_fwd(
        x.data_ptr(), out.data_ptr(), b, n, level, gh.ctypes.data,
        hh.ctypes.data, m, tile, halo(m, level),
        smem_bytes(level, m, "pfwd"), DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "MODWPT forward kernel")
    modwpt_fwd_cuda.launches += 1
    return out


@modwpt_fwd_op.register_fake
def _(x, g, h, level):
    _check_pfwd(x, g, h, level, "pfwd", "MODWPT forward")
    return x.new_empty((1 << level,) + tuple(x.shape))


def modwpt_fwd_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                    level: int) -> torch.Tensor:
    """Launch the forward kernel as ``jwave::modwpt_fwd``: x (B, N) →
    (2^level, B, N), x's dtype."""
    return modwpt_fwd_op(x, *op_taps(wavelet), level)


modwpt_fwd_cuda.launches = 0


def _check_pinv(c: torch.Tensor, g, h, traced: bool = True) -> int:
    check_operand(c, "coeffs", 3, traced)
    nodes, n = c.shape[0], c.shape[2]
    if nodes < 2 or nodes & (nodes - 1):
        raise ValueError(f"coeffs: leading axis must be 2^level ≥ 2 packet "
                         f"nodes, got {nodes}")
    level = nodes.bit_length() - 1
    _require(n, level, check_taps(g, h), "pinv", c.shape, "MODWPT inverse")
    return level


@kernel_op("modwpt_inv")
def modwpt_inv_op(c: torch.Tensor, g: list[float], h: list[float]
                  ) -> torch.Tensor:
    """The inverse kernel's launch as an operator (``torch.ops.jwave.
    modwpt_inv``): c (2^level, B, N) → (B, N), c's dtype."""
    level = _check_pinv(c, g, h, traced=False)
    _, b, n = c.shape
    m = len(g)
    tile = tile_of("pinv", level, m)
    check_grid(b, n, "pinv", tile)
    out = torch.empty((b, n), dtype=c.dtype, device=c.device)
    gh, hh = host_taps(g, h)
    lib = _lib()
    code = lib.jw_modwpt_inv(
        c.data_ptr(), out.data_ptr(), b, n, level, gh.ctypes.data,
        hh.ctypes.data, m, tile, halo(m, level),
        smem_bytes(level, m, "pinv"), DTYPE_CODES[c.dtype], c.device.index,
        torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(lib, code, "MODWPT inverse kernel")
    modwpt_inv_cuda.launches += 1
    return out


@modwpt_inv_op.register_fake
def _(c, g, h):
    _check_pinv(c, g, h)
    return c.new_empty(tuple(c.shape[1:]))


def modwpt_inv_cuda(c: torch.Tensor, wavelet: DiscreteWavelet
                    ) -> torch.Tensor:
    """Launch the inverse kernel as ``jwave::modwpt_inv``: c (2^level,
    B, N) → (B, N), c's dtype."""
    return modwpt_inv_op(c, *op_taps(wavelet))


modwpt_inv_cuda.launches = 0


def select_plan(batch: int, n: int, level: int, m: int) -> TilePlan:
    """The select kernel's launch (:func:`kernels.modwt_cuda.tile_plan`)."""
    return tile_plan("select", batch, n, level, m)


@kernel_op("modwpt_select")
def modwpt_select_op(x: torch.Tensor, g: list[float], h: list[float],
                     level: int) -> torch.Tensor:
    """The select kernel's launch as an operator (``torch.ops.jwave.
    modwpt_select``): x (B, N) → (3, 2^level, B) float32, the rows |w|,
    the position's int32 bits and w.  The tile plan, the tiles' keys and
    the ticket buffer are taken here, from the concrete batch; one launch
    and nothing else on the stream."""
    _check_pfwd(x, g, h, level, "select", "MODWPT select", traced=False)
    b, n = x.shape
    m = len(g)
    plan = select_plan(b, n, level, m)
    nodes = 1 << level
    # each tile's best per leaf as a 64-bit key; the rows' (|w|, position
    # bits, w)
    partial = torch.empty((nodes, b, plan.ntiles), dtype=torch.int64,
                          device=x.device)
    out = torch.empty((3, nodes, b), dtype=torch.float32, device=x.device)
    gh, hh = host_taps(g, h)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    code = lib.jw_modwpt_select(
        x.data_ptr(), partial.data_ptr(), tickets(x.device, stream, b),
        out.data_ptr(), b, n, level, gh.ctypes.data, hh.ctypes.data, m,
        plan.tile, plan.smem, DTYPE_CODES[x.dtype], x.device.index, stream)
    _build.check(lib, code, "MODWPT select kernel")
    modwpt_select_cuda.launches += 1
    return out


@modwpt_select_op.register_fake
def _(x, g, h, level):
    _check_pfwd(x, g, h, level, "select", "MODWPT select")
    return x.new_empty((3, 1 << level, x.shape[0]), dtype=torch.float32)


def modwpt_select_cuda(x: torch.Tensor, wavelet: DiscreteWavelet,
                       level: int):
    """Launch the select kernel as ``jwave::modwpt_select``: x (B, N) →
    ``(absmax, shift, value)``, each (2^level, B): float32, int32,
    float32."""
    absmax, shift, value = modwpt_select_op(
        x, *op_taps(wavelet), level).unbind(0)
    return absmax, shift.view(torch.int32), value


modwpt_select_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatch by device, and the autograd pair
# ---------------------------------------------------------------------------

def select_fused_supported(batch: int, n: int, level: int, m: int) -> bool:
    """Whether :func:`modwpt_select_fused` runs (B, N) at this level and
    filter length; the counterpart of the JAX package's plan function."""
    return batch >= 1 and kernel_supported(n, level, m, "select")


def modwpt_select_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                        level: int):
    """Per-node best correlation of x (B, N): ``(absmax, shift, value)``
    each ``(2^level, B)`` — max |W|, its time index (the first, on ties),
    its signed coefficient; the arg-max over :func:`modwpt_fused`'s output
    without writing it.  A CUDA tensor runs the kernel or raises; a CPU
    tensor runs the plain version."""
    if x.ndim != 2:
        raise ValueError(f"fused select takes (B, N), got {tuple(x.shape)}")
    n = x.shape[-1]
    _check_level(n, level)
    _require(n, level, wavelet.length, "select", x.shape, "fused select")
    if x.is_cuda:
        return modwpt_select_cuda(x.contiguous(), wavelet, level)
    if x.device.type != "cpu":
        raise ValueError(f"no select kernel for device {x.device}")
    return modwpt_select_plain(x, wavelet, level)


def _modwpt_fused_impl(x: torch.Tensor, wavelet: DiscreteWavelet,
                       level: int) -> torch.Tensor:
    if x.ndim not in (1, 2):
        raise ValueError(f"fused MODWPT takes (N,) or (B, N), got "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    _check_level(n, level)
    _require(n, level, wavelet.length, "pfwd", x.shape, "fused MODWPT")
    if x.is_cuda:
        out = modwpt_fwd_cuda(x.contiguous().reshape(-1, n), wavelet, level)
        return out.reshape((1 << level,) + tuple(x.shape))
    if x.device.type != "cpu":
        raise ValueError(f"no MODWPT kernel for device {x.device}")
    return modwpt_fwd_plain(x, wavelet, level)


def _imodwpt_fused_impl(c: torch.Tensor, wavelet: DiscreteWavelet
                        ) -> torch.Tensor:
    if c.ndim not in (2, 3):
        raise ValueError(f"fused iMODWPT takes (2^L, N) or (2^L, B, N), got "
                         f"{tuple(c.shape)}")
    nodes, n = c.shape[0], c.shape[-1]
    if nodes < 2 or nodes & (nodes - 1):
        raise ValueError(f"leading axis must be 2^level ≥ 2 packet nodes, "
                         f"got {nodes}")
    _require(n, nodes.bit_length() - 1, wavelet.length, "pinv", c.shape,
             "fused iMODWPT")
    if c.is_cuda:
        out = modwpt_inv_cuda(c.contiguous().reshape(nodes, -1, n), wavelet)
        return out.reshape(tuple(c.shape[1:]))
    if c.device.type != "cpu":
        raise ValueError(f"no iMODWPT kernel for device {c.device}")
    return modwpt_inv_plain(c, wavelet)


class _ModwptFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wavelet, level):
        ctx.wavelet = wavelet
        return _modwpt_fused_impl(x, wavelet, level)

    @staticmethod
    def backward(ctx, cot):
        return _imodwpt_fused_impl(cot, ctx.wavelet), None, None


class _ImodwptFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, wavelet):
        ctx.wavelet, ctx.level = wavelet, c.shape[0].bit_length() - 1
        return _imodwpt_fused_impl(c, wavelet)

    @staticmethod
    def backward(ctx, cot):
        return _modwpt_fused_impl(cot, ctx.wavelet, ctx.level), None


def modwpt_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                 level: int) -> torch.Tensor:
    """Fused forward MODWPT: x (B, N) → (2^level, B, N), (N,) →
    (2^level, N); differentiable (the backward is the inverse kernel).

    A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
    version.  Raises for shapes :func:`kernel_supported` rejects.
    """
    return _ModwptFused.apply(x, wavelet, level)


def imodwpt_fused(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Fused inverse MODWPT: (2^level, B, N) → (B, N), (2^level, N) → (N,);
    differentiable (the backward is the forward kernel)."""
    return _ImodwptFused.apply(c, wavelet)
