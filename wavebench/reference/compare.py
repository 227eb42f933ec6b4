"""The number a cell's check compares: the largest gap between an answer
and the reference, over the largest magnitude of the reference."""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|, in float64."""
    want = _wide(want)
    return float((_wide(got) - want).abs().max() / want.abs().max())


def rel_err_rows(got: torch.Tensor, reference, rows: int, axis: int,
                 block: int = 8) -> float:
    """:func:`rel_err` against a reference computed ``block`` rows at a
    time: ``reference(i, j)`` gives the reference of rows i … j−1, which
    lie along ``axis`` of ``got``."""
    gap = top = 0.0
    for i in range(0, rows, block):
        j = min(i + block, rows)
        want = _wide(reference(i, j))
        part = _wide(got.narrow(axis, i, j - i))
        gap = max(gap, float((part - want).abs().max()))
        top = max(top, float(want.abs().max()))
    return gap / top
