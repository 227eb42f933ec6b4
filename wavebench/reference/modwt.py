"""The MODWT, its inverse and the universal soft-threshold denoise, plain.

Level j filters are the base filters with 2^(j−1) − 1 zeros between taps,
applied as circular convolutions along the last axis:

    W_j[n] = Σ_k h̃[k]·V_{j−1}[(n − k·2^(j−1)) mod N]
    V_j[n] = Σ_k g̃[k]·V_{j−1}[(n − k·2^(j−1)) mod N],   V_0 = x

and the inverse runs the adjoints from V_J down:

    V_{j−1}[n] = Σ_k g̃[k]·V_j[(n + k·2^(j−1)) mod N]
               + h̃[k]·W_j[(n + k·2^(j−1)) mod N].

Everything is computed in float64 on the inputs' device.
"""
from __future__ import annotations

import math

import torch


def modwt(x: torch.Tensor, filters, level: int) -> torch.Tensor:
    """(level + 1, ..., N): rows W_1 … W_J, then V_J."""
    g, h = filters
    v = x.double()
    rows = []
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        w_next = torch.zeros_like(v)
        v_next = torch.zeros_like(v)
        for k in range(len(g)):
            r = torch.roll(v, k * d, dims=-1)
            w_next += h[k] * r
            v_next += g[k] * r
        rows.append(w_next)
        v = v_next
    rows.append(v)
    return torch.stack(rows)


def imodwt(c: torch.Tensor, filters) -> torch.Tensor:
    """The signal whose MODWT is ``c`` (level + 1, ..., N)."""
    g, h = filters
    level = c.shape[0] - 1
    v = c[level].double()
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        w = c[j - 1].double()
        acc = torch.zeros_like(v)
        for k in range(len(g)):
            acc += torch.roll(g[k] * v + h[k] * w, -k * d, dims=-1)
        v = acc
    return v


def median(a: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, the mean of the two middle values for an
    even count."""
    n = a.shape[-1]
    s = torch.sort(a, dim=-1).values
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def denoise(x: torch.Tensor, filters, level: int) -> torch.Tensor:
    """Soft-threshold every detail row at the universal threshold
    σ·√(2·ln N), σ = median(|W_1|)/0.6745 per signal, keep V_J, invert."""
    c = modwt(x, filters, level)
    n = x.shape[-1]
    t = (median(c[0].abs()) / 0.6745 * math.sqrt(2.0 * math.log(n)))[..., None]
    details = torch.sign(c[:level]) * torch.clamp_min(c[:level].abs() - t, 0.0)
    return imodwt(torch.cat([details, c[level:]]), filters)


def causal_tail(history: torch.Tensor, filters, level: int,
                width: int) -> torch.Tensor:
    """The MODWT of a stream at its last ``width`` samples, each column
    from the samples at and before it: (level + 1, width).

    Column τ of level J reads back (M − 1)(2^J − 1) samples, so the
    circular transform of the last ``width`` + that many samples equals the
    causal one on its last ``width`` columns."""
    m = len(filters[0])
    halo = (m - 1) * ((1 << level) - 1)
    if history.shape[-1] < width + halo:
        raise ValueError("the stream's history is shorter than its window")
    window = history[..., -(width + halo):]
    return modwt(window, filters, level)[..., halo:]

