"""Fused MODWPT (packet tree) kernels for the H100 (``csrc/modwpt.cu``).

Replaces ``jwave_pro_tpu/kernels/modwpt_pallas.py``:

* ``jw_modwpt_fwd_kernel`` ← ``_forward_kernel`` (``:128``): x (B, N) →
  all 2^L leaves ``(2^L, B, N)`` in sequency order ``n ^ ((n>>1)&1)``.
* ``jw_modwpt_select_kernel`` ← ``_select_kernel`` (``:264``): the same
  cascade with a per-node arg-max of |w| in place of the stores —
  ``(absmax, shift, value)``, each ``(2^L, B)``; the ``(2^L, B, N)`` block is
  never written.  Each block writes its tile's best per node, and the
  row's last block to finish (an atomic ticket, :func:`_launch.tickets`) merges the
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
``modwpt_inv_plain``, ``modwpt_select_plain``) and a launch count
(``_launch.LAUNCHES["<op>"]``).  Each launch is an operator
(``jwave::modwpt_fwd``, ``jwave::modwpt_select``, ``jwave::modwpt_inv``).
bfloat16 is read and written as bfloat16 and computed in float32; the select
returns float32.  The autograd pair (:func:`modwpt_fused`,
:func:`imodwpt_fused`) rests on Aᵀ = A⁻¹: every level applies the same
√2-normalized perfect-reconstruction pair to each node and the sequency
reorder is a permutation, so each direction's backward is the other kernel.
"""
from __future__ import annotations

import torch

from ..ops.modwpt import _level_forward, _level_inverse
from ..ops.modwt import _check_level, modwt_base_filters
from ..wavelets.base import DiscreteWavelet
from ._launch import (
    DTYPE_CODES, check_grid, check_operand, check_taps, compute_dtype,
    host_taps, kernel_op, launch, op_taps, tickets,
)
from .modwt_cuda import (
    KernelPlan, TilePlan, check_fused, kernel_supported, require_plan,
    tile_plan,
)

__all__ = [
    "modwpt_fused", "imodwpt_fused", "ModwptFused", "ImodwptFused",
    "modwpt_select_fused",
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
    nodes = x.to(compute_dtype(x.dtype))[None]
    for j in range(1, level + 1):
        nodes = _level_forward(nodes, g, h, j, "direct")
    return nodes.to(x.dtype)


def modwpt_inv_plain(c: torch.Tensor, wavelet: DiscreteWavelet
                     ) -> torch.Tensor:
    """The inverse kernel's function in plain PyTorch: ``(2^level, ..., N)``
    → ``(..., N)``, computed like :func:`modwpt_fwd_plain`."""
    g, h = modwt_base_filters(wavelet)
    nodes = c.to(compute_dtype(c.dtype))
    for j in range(c.shape[0].bit_length() - 1, 0, -1):
        nodes = _level_inverse(nodes, g, h, j, "direct")
    return nodes[0].to(c.dtype)


def modwpt_select_plain(x: torch.Tensor, wavelet: DiscreteWavelet,
                        level: int):
    """The select kernel's function in plain PyTorch: x (B, N) →
    ``(absmax, shift, value)``, each ``(2^level, B)``: per node the largest
    |w| (float32; float64 for float64 input), its first position (int32) and
    the signed coefficient there."""
    c = modwpt_fwd_plain(x.to(compute_dtype(x.dtype)), wavelet, level)
    shift = torch.argmax(torch.abs(c), dim=-1, keepdim=True)
    value = torch.gather(c, -1, shift)[..., 0]
    return torch.abs(value), shift[..., 0].to(torch.int32), value


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_pfwd(x: torch.Tensor, g, h, level: int, kind: str,
                what: str, traced: bool = True) -> KernelPlan:
    check_operand(x, "x", 2, traced)
    return require_plan(kind, x.shape[1], level, check_taps(g, h), x.shape,
                        what)


@kernel_op("modwpt_fwd")
def modwpt_fwd_op(x: torch.Tensor, g: list[float], h: list[float],
                  level: int) -> torch.Tensor:
    """The forward kernel's launch as an operator (``torch.ops.jwave.
    modwpt_fwd``): x (B, N) → (2^level, B, N), x's dtype."""
    plan = _check_pfwd(x, g, h, level, "pfwd", "MODWPT forward", traced=False)
    b, n = x.shape
    check_grid(b, n, plan.tile)
    out = torch.empty((1 << level, b, n), dtype=x.dtype, device=x.device)
    gh, hh = host_taps(g, h)
    launch("jw_modwpt_fwd", "MODWPT forward kernel", x.device, x.data_ptr(),
           out.data_ptr(), b, n, level, gh.ctypes.data, hh.ctypes.data,
           len(g), *plan, DTYPE_CODES[x.dtype])
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


def _packet_level(c: torch.Tensor, msg: str) -> int:
    """The level of a (2^level, ...) packet stack; raise ``msg`` with the
    node count unless it is a power of two ≥ 2."""
    nodes = c.shape[0]
    if nodes < 2 or nodes & (nodes - 1):
        raise ValueError(f"{msg} 2^level ≥ 2 packet nodes, got {nodes}")
    return nodes.bit_length() - 1


def _check_pinv(c: torch.Tensor, g, h,
                traced: bool = True) -> tuple[int, KernelPlan]:
    check_operand(c, "coeffs", 3, traced)
    level = _packet_level(c, "coeffs: leading axis must be")
    return level, require_plan("pinv", c.shape[2], level, check_taps(g, h),
                               c.shape, "MODWPT inverse")


@kernel_op("modwpt_inv")
def modwpt_inv_op(c: torch.Tensor, g: list[float], h: list[float]
                  ) -> torch.Tensor:
    """The inverse kernel's launch as an operator (``torch.ops.jwave.
    modwpt_inv``): c (2^level, B, N) → (B, N), c's dtype."""
    level, plan = _check_pinv(c, g, h, traced=False)
    _, b, n = c.shape
    check_grid(b, n, plan.tile)
    out = torch.empty((b, n), dtype=c.dtype, device=c.device)
    gh, hh = host_taps(g, h)
    launch("jw_modwpt_inv", "MODWPT inverse kernel", c.device, c.data_ptr(),
           out.data_ptr(), b, n, level, gh.ctypes.data, hh.ctypes.data,
           len(g), *plan, DTYPE_CODES[c.dtype])
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
    check_operand(x, "x", 2)
    b, n = x.shape
    plan = select_plan(b, n, level, check_taps(g, h))
    nodes = 1 << level
    # each tile's best per leaf as a 64-bit key; the rows' (|w|, position
    # bits, w)
    partial = torch.empty((nodes, b, plan.ntiles), dtype=torch.int64,
                          device=x.device)
    out = torch.empty((3, nodes, b), dtype=torch.float32, device=x.device)
    gh, hh = host_taps(g, h)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch("jw_modwpt_select", "MODWPT select kernel", x.device,
           x.data_ptr(), partial.data_ptr(), tickets(x.device, stream, b),
           out.data_ptr(), b, n, level, gh.ctypes.data, hh.ctypes.data,
           len(g), plan.tile, plan.smem, DTYPE_CODES[x.dtype], stream=stream)
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
    _check_level(x.shape[-1], level)
    check_fused(x, "select", level, wavelet.length, "fused select")
    if x.is_cuda:
        return modwpt_select_cuda(x.contiguous(), wavelet, level)
    return modwpt_select_plain(x, wavelet, level)


def _fwd(x: torch.Tensor, wavelet: DiscreteWavelet,
         level: int) -> torch.Tensor:
    if not x.is_cuda:
        return modwpt_fwd_plain(x, wavelet, level)
    out = modwpt_fwd_cuda(x.contiguous().reshape(-1, x.shape[-1]), wavelet,
                          level)
    return out.reshape((1 << level,) + tuple(x.shape))


def _inv(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    if not c.is_cuda:
        return modwpt_inv_plain(c, wavelet)
    out = modwpt_inv_cuda(c.contiguous().reshape(c.shape[0], -1,
                                                 c.shape[-1]), wavelet)
    return out.reshape(tuple(c.shape[1:]))


class ModwptFused(torch.autograd.Function):
    """The packet forward kernel (the plain version off the card) with the
    inverse as its backward, unchecked: for a caller that has checked the
    shape, as :func:`modwpt_fused` and ``ops/modwpt.py:_try_kernel`` do."""
    @staticmethod
    def forward(ctx, x, wavelet, level):
        ctx.wavelet = wavelet
        return _fwd(x, wavelet, level)

    @staticmethod
    def backward(ctx, cot):
        return _inv(cot, ctx.wavelet), None, None


class ImodwptFused(torch.autograd.Function):
    """The packet inverse kernel with the forward as its backward,
    unchecked, as :class:`ModwptFused`."""
    @staticmethod
    def forward(ctx, c, wavelet):
        ctx.wavelet, ctx.level = wavelet, c.shape[0].bit_length() - 1
        return _inv(c, wavelet)

    @staticmethod
    def backward(ctx, cot):
        return _fwd(cot, ctx.wavelet, ctx.level), None


def modwpt_fused(x: torch.Tensor, wavelet: DiscreteWavelet,
                 level: int) -> torch.Tensor:
    """Fused forward MODWPT: x (B, N) → (2^level, B, N), (N,) →
    (2^level, N); differentiable (the backward is the inverse kernel).

    A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
    version.  Raises for shapes :func:`kernel_supported` rejects.
    """
    if x.ndim not in (1, 2):
        raise ValueError(f"fused MODWPT takes (N,) or (B, N), got "
                         f"{tuple(x.shape)}")
    _check_level(x.shape[-1], level)
    check_fused(x, "pfwd", level, wavelet.length, "fused MODWPT")
    return ModwptFused.apply(x, wavelet, level)


def imodwpt_fused(c: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """Fused inverse MODWPT: (2^level, B, N) → (B, N), (2^level, N) → (N,);
    differentiable (the backward is the forward kernel)."""
    if c.ndim not in (2, 3):
        raise ValueError(f"fused iMODWPT takes (2^L, N) or (2^L, B, N), got "
                         f"{tuple(c.shape)}")
    level = _packet_level(c, "leading axis must be")
    check_fused(c, "pinv", level, wavelet.length, "fused iMODWPT")
    return ImodwptFused.apply(c, wavelet)
