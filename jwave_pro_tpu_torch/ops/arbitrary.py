"""Arbitrary-length wrappers: Ancient Egyptian Decomposition + Shifting WT.

Counterpart of ``jwave_pro_tpu/ops/arbitrary.py``; same semantics and
names.

AED (``jwave/transforms/AncientEgyptianDecomposition.java:97-183``): split N
into decreasing powers of two (42 = 32 + 8 + 2, ``tools/MathToolKit.java:
57-101``), transform each contiguous block independently with any wrapped
transform, concatenate.

SWT (``jwave/transforms/ShiftingWaveletTransform.java:43-139``): slide a
single filter-bank step of width div = 2, 4, 8, … across all complete blocks;
trailing odd sample passed through.  Faithful to the reference, including its
quirk that reverse is only an exact inverse for power-of-two lengths (the
reverse pass starts from an even width the forward never visited otherwise).

.. warning:: **Non-power-of-two even lengths round-trip to garbage.**  The
   reference's reverse (``ShiftingWaveletTransform.java:93-139``) starts from
   ``div = length`` when the length is even — a block width the forward never
   used unless the length is a power of two — so ``swt_inverse(swt_forward(x))``
   on e.g. N=42 returns values that are wrong by O(1).  The contract:

   * N a power of two → exact round trip;
   * N odd → trailing sample passed through; round trip exact only for
     N = 2^k + 1 (the even head is then a power of two);
   * N even, not a power of two → **forward ≠ inverse⁻¹** (reference-faithful
     corruption).  Pass ``strict=True`` to raise ``NotValid`` instead of
     silently producing a non-invertible result.

   Where the reverse reaches an odd block width (N odd, e.g. 43: 42 → 21),
   :func:`~.fwt.synthesis_step` folds that width as the reference does with
   integer halving; a forward never reaches an odd width.
"""
from __future__ import annotations

import torch

from ..exceptions import NotValid
from ..utils.device import as_signal
from ..utils.validation import ancient_egyptian_decomposition
from ..wavelets.base import DiscreteWavelet
from .fwt import analysis_step, fwt, ifwt, synthesis_step

__all__ = ["aed_forward", "aed_inverse", "swt_forward", "swt_inverse"]


def _swt_invertible(n: int) -> bool:
    """Lengths whose SWT forward/reverse schedules agree (see module warning).

    Power-of-two N, and N = 2^k + 1 (odd ⇒ trailing passthrough and the even
    head is then a power of two, so both directions visit the same widths).
    """
    head = n if n % 2 == 0 else n - 1
    # head == 0 (n == 1): both directions are no-ops — trivially exact
    return head == 0 or (head & (head - 1)) == 0


def _swt_check(n: int, strict: bool, name: str) -> None:
    if strict and not _swt_invertible(n):
        raise NotValid(
            f"{name}: length {n} is not a power of two (or 2^k + 1); the "
            "shifting-WT reverse schedule diverges from the forward there "
            "and the round trip is not exact "
            "(reference ShiftingWaveletTransform.java:93-139 has the same "
            "behavior). Use aed_forward/aed_inverse or MODWT for "
            "arbitrary-length signals.")


def _aed(x: torch.Tensor, wavelet: DiscreteWavelet, transform, level):
    out = []
    off = 0
    for block in ancient_egyptian_decomposition(x.shape[-1]):
        out.append(transform(x[..., off:off + block], wavelet, level))
        off += block
    return torch.cat(out, dim=-1)


def aed_forward(x: torch.Tensor, wavelet: DiscreteWavelet, transform=None,
                level=None) -> torch.Tensor:
    """Forward transform of arbitrary-length signals via power-of-2 blocks.

    ``transform(block, wavelet, level)`` defaults to :func:`~.fwt.fwt`.
    """
    return _aed(as_signal(x), wavelet, transform or fwt, level)


def aed_inverse(y: torch.Tensor, wavelet: DiscreteWavelet, transform=None,
                level=None) -> torch.Tensor:
    """Inverse of :func:`aed_forward`; ``transform`` defaults to
    :func:`~.fwt.ifwt`."""
    return _aed(as_signal(y), wavelet, transform or ifwt, level)


def _swt_apply(x, wavelet, div, step):
    """Apply one width-``div`` step to all complete blocks of the last axis."""
    n = x.shape[-1]
    splits = n // div
    head_len = splits * div
    blocks = x[..., :head_len].reshape(x.shape[:-1] + (splits, div))
    head = step(blocks, wavelet).reshape(x.shape[:-1] + (head_len,))
    return torch.cat([head, x[..., head_len:]], dim=-1) \
        if head_len < n else head


def _keep_last(y: torch.Tensor, orig_last: torch.Tensor) -> torch.Tensor:
    """``y`` with its last sample replaced by ``orig_last`` (out of place,
    so autograd sees it)."""
    return torch.cat([y[..., :-1], orig_last[..., None]], dim=-1)


def swt_forward(x: torch.Tensor, wavelet: DiscreteWavelet,
                strict: bool = False) -> torch.Tensor:
    """ShiftingWaveletTransform.forward (``:43-84``).

    .. warning:: Only power-of-two (and 2^k + 1) lengths round-trip through
       :func:`swt_inverse` — see the module docstring.  ``strict=True``
       raises :class:`~jwave_pro_tpu_torch.exceptions.NotValid` for other
       lengths.
    """
    x = as_signal(x)
    n = x.shape[-1]
    _swt_check(n, strict, "swt_forward")
    orig_last = x[..., n - 1]
    div = 2
    while div <= n:
        x = _swt_apply(x, wavelet, div, analysis_step)
        div *= 2
    return _keep_last(x, orig_last) if n % 2 == 1 else x


def swt_inverse(y: torch.Tensor, wavelet: DiscreteWavelet,
                strict: bool = False) -> torch.Tensor:
    """ShiftingWaveletTransform.reverse (``:93-139``).

    .. warning:: Exact inverse of :func:`swt_forward` only for power-of-two
       (and 2^k + 1) lengths — see the module docstring.  ``strict=True``
       raises :class:`~jwave_pro_tpu_torch.exceptions.NotValid` for other
       lengths.
    """
    y = as_signal(y)
    n = y.shape[-1]
    _swt_check(n, strict, "swt_inverse")
    orig_last = y[..., n - 1]
    div = n if n % 2 == 0 else (n // 2) * 2
    while div >= 2:
        y = _swt_apply(y, wavelet, div, synthesis_step)
        div //= 2
    return _keep_last(y, orig_last) if n % 2 == 1 else y
