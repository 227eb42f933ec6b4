"""The MODWT of one shard of a circular signal, plain.

A signal sharded along time over a ring of ranks is, for each rank, a
shard x (rows, n) with the rest of the signal around it.  Column t of the
level-J MODWT reads the samples t − H … t of the whole signal,
H = (M − 1)(2^J − 1), so the shard's coefficients follow from the shard
and the H samples before its first one (the left neighbour's last, or the
signal's end for the first shard): the circular transform of those H + w
samples, from column H on, is the signal's on the w columns after them
(as ``modwt.causal_tail`` reads a stream's last columns).

The columns are computed ``block`` at a time, so a block of a shard of
any length fits beside it; everything in float64 on the inputs' device.
"""
from __future__ import annotations

import torch

from . import modwt


def halo(filters, level: int) -> int:
    """Samples before a column that its level-``level`` coefficients read:
    (M − 1)(2^level − 1)."""
    return (len(filters[0]) - 1) * ((1 << level) - 1)


def modwt_segment(x: torch.Tensor, context: torch.Tensor, filters,
                  level: int, start: int = 0, width: int | None = None,
                  block: int = 1 << 16) -> torch.Tensor:
    """(level + 1, rows, width) float64: the MODWT of the whole signal on
    columns ``start`` … ``start + width − 1`` of the shard ``x`` (rows, n),
    from the shard and ``context`` (rows, H), the H samples before its
    column 0."""
    n = x.shape[-1]
    h = halo(filters, level)
    if context.shape[-1] != h:
        raise ValueError(f"context of {context.shape[-1]} samples; level "
                         f"{level} needs {h}")
    width = n - start if width is None else width
    if start < 0 or width < 0 or start + width > n:
        raise ValueError(f"columns {start}…{start + width} of a shard of "
                         f"{n}")
    out = []
    for lo in range(start, start + width, block):
        hi = min(lo + block, start + width)
        # samples lo − h … hi − 1 of [context | x]; context index i is
        # shard position i − h
        if lo >= h:
            window = x[..., lo - h:hi]
        else:
            window = torch.cat([context[..., lo:], x[..., :hi]], dim=-1)
        out.append(modwt.modwt(window, filters, level)[..., h:])
    return torch.cat(out, dim=-1)
