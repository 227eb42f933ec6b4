"""Exact per-row median by radix select for the H100 (``csrc/median.cu``).

Replaces no Pallas kernel: the JAX package takes the denoise threshold's
median with ``jnp.median``, a sort.  The exact selection it models is the
JAX package's ``median_select`` (``jwave_pro_tpu/ops/financial.py``): a
k-th key search over the values' order keys, and for an even count the
second middle from the tie count or the smallest key above the first.
The result is bitwise the sort path's (``ops/denoise.py:_sort_median``):
the float32 midpoint ``(lo + hi) * 0.5`` for every count, NaN for a row
that holds a NaN, with one exception on signed input: order keys put −0
below +0, where the sort may return either at the middle.

What bounds it on the H100: one read of the rows a pass, three passes of
11/11/10-bit digits.  The kernel folds ``|x|``, the NaN flag and both
middles into those reads, splits each row over enough blocks to fill the
SMs (:func:`median_parts`), and finishes each pass inside its launch: the
row's last block scans the row's histogram (an atomic ticket, as the
variance kernel's) and leaves its scratch zero.  A call is three launches
and no host synchronisation; one block a row runs all three passes in one
launch.

Beside the kernel: its plain PyTorch version (:func:`median_plain`, the
same passes), which the CPU runs; the launch count
``_launch.LAUNCHES["median"]``; the operator ``jwave::median``.
"""
from __future__ import annotations

import torch

from ._launch import (
    check_operand, kernel_op, launch, sm_count, tickets, zeroed,
)

__all__ = ["median_rows", "median_plain", "median_op", "median_parts"]

BINS = 2048                    # JW_MED_BINS in csrc/median.cu
SLOTS = BINS + 2               # JW_MED_SLOTS: the bins, NaN count, maximum
STATE = 5                      # unsigned words of JwMedState
# the digits of the three passes, from the top: (shift, width)
DIGITS = ((21, 11), (10, 11), (0, 10))
BLOCKS_PER_SM = 4              # 512-thread blocks an SM (launch bounds)
MIN_PART = 8192                # elements a block reads at least


def _order_keys(x: torch.Tensor, absolute: bool) -> torch.Tensor:
    """float32 → its order keys as int64 in [0, 2³²): the sign bit set
    for a positive value, every bit flipped for a negative one, so the
    keys' order is the values' (−0 below +0; NaN above +inf or below
    −inf by its sign).  ``absolute``: the keys of |x|."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if absolute:
        return u | 0x80000000
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def _key_values(k: torch.Tensor) -> torch.Tensor:
    """Order keys (int64) back to their float32 values."""
    bits = torch.where(k >= 0x80000000, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    bits = bits - (bits >= 0x80000000).to(torch.int64) * (1 << 32)
    return bits.to(torch.int32).view(torch.float32)


def median_plain(x: torch.Tensor, absolute: bool = False) -> torch.Tensor:
    """The median kernel's function in plain PyTorch, pass for pass:
    ``(R, n)`` float32 → ``(R,)`` medians of the rows (of ``|x|`` for
    ``absolute``).  Each pass counts the keys under the row's prefix in
    one histogram of the next digit and takes the buckets of both middle
    ranks; where they split, the second middle is the smallest key above
    the first's bucket, taken in the next pass (the bucket itself in the
    last).  No step branches on the data, so it traces."""
    rows, n = x.shape
    keys = _order_keys(x, absolute)
    d = 1 - n % 2                  # second middle's rank − the first's
    prefix = torch.zeros(rows, dtype=torch.int64, device=x.device)
    rank = torch.full_like(prefix, (n - 1) // 2)
    pending = torch.zeros(rows, dtype=torch.bool, device=x.device)
    second = torch.full_like(prefix, -1)   # second middle's key, once known
    lim = torch.zeros_like(prefix)         # top key of the first's bucket
    for s, w in DIGITS:
        counted = (keys >> (s + w)) == prefix[:, None]
        hist = torch.zeros((rows, 1 << w), dtype=torch.int64,
                           device=x.device).scatter_add_(
            1, (keys >> s) & ((1 << w) - 1), counted.to(torch.int64))
        above = torch.where(keys > lim[:, None], keys,
                            torch.iinfo(torch.int64).max).amin(-1)
        second = torch.where(pending, above, second)
        cum = hist.cumsum(-1)
        b1 = (cum <= rank[:, None]).sum(-1)
        b2 = (cum <= (rank + d)[:, None]).sum(-1)
        below = (cum - hist).gather(-1, b1[:, None])[:, 0]
        split = (second < 0) & ~pending & (b2 != b1)
        new = (prefix << w) | b1
        if s == 0:
            second = torch.where(split, (prefix << w) | b2, second)
        lim = (new << s) | ((1 << s) - 1)
        pending = split if s else torch.zeros_like(split)
        prefix, rank = new, rank - below
    lo = _key_values(prefix)
    hi = _key_values(torch.where(second < 0, prefix, second))
    mid = (lo + hi) * 0.5
    return torch.where(torch.isnan(x).any(-1), torch.nan, mid)


def median_parts(rows: int, n: int, sms: int) -> int:
    """Blocks a row: enough for ``BLOCKS_PER_SM`` blocks on each of the
    ``sms`` SMs, no more than leave each ``MIN_PART`` elements, at least
    one."""
    want = -(-BLOCKS_PER_SM * sms // rows)
    return max(1, min(want, n // MIN_PART))


def _check_median(x: torch.Tensor, traced: bool = True) -> None:
    check_operand(x, "x", 2, traced, (torch.float32,))
    if x.shape[0] < 1 or not 1 <= x.shape[1] < 2 ** 31:
        raise ValueError(f"x: expected (rows, n) with rows ≥ 1 and "
                         f"1 ≤ n < 2³¹, got {tuple(x.shape)}")


@kernel_op("median")
def median_op(x: torch.Tensor, absolute: bool) -> torch.Tensor:
    """The median kernel's launches as an operator (``torch.ops.jwave.
    median``): x (R, n) float32 → (R,) float32 medians of its rows (of
    |x| for ``absolute``).  The blocks a row, the row state and the
    scratch are taken here, from the concrete shape."""
    _check_median(x, traced=False)
    rows, n = x.shape
    parts = median_parts(rows, n, sm_count(x.device.index))
    if rows * parts >= 2 ** 31:
        raise ValueError(f"{rows}×{n} exceeds the median kernel's grid")
    state = torch.empty((rows, STATE), dtype=torch.int32, device=x.device)
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = ticket = None
    if parts > 1:    # the rows' histograms, which their last blocks reset
        scratch = zeroed("median", x.device, stream, rows * SLOTS)
        ticket = tickets(x.device, stream, rows)
    launch("jw_median", "median kernel", x.device, x.data_ptr(),
           state.data_ptr(), scratch, ticket, out.data_ptr(), rows, n, parts,
           int(absolute), stream=stream)
    return out


@median_op.register_fake
def _(x, absolute):
    _check_median(x)
    return x.new_empty(x.shape[:1])


def median_rows(x: torch.Tensor, absolute: bool = False) -> torch.Tensor:
    """Median over the last axis of a float32 ``(..., n)`` tensor (of
    ``|x|`` for ``absolute``) → ``(...)``.  A CUDA tensor runs the kernel
    on its last axis made contiguous; any other runs the plain version."""
    flat = x.reshape(-1, x.shape[-1])
    out = (median_op(flat.contiguous(), absolute) if x.is_cuda
           else median_plain(flat, absolute))
    return out.reshape(x.shape[:-1])
