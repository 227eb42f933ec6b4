"""Lifting-scheme transforms: CDF 5/3 (LeGall) and CDF 9/7 (JPEG2000).

Counterpart of ``jwave_pro_tpu/ops/lifting.py``; same semantics and names.
The reference ships tap tables for these (``other/CDF53.java``,
``other/CDF97.java``) but its builder refuses to construct them — the odd
tap counts don't fit its stride-2 convolution (``WaveletBuilder.java:
363-385`` throws).  Here they run through the lifting scheme: predict and
update steps on the even/odd polyphase halves with periodic rolls,
elementwise adds on the tensor's device, exactly invertible by running the
steps backwards.

Layout matches the FWT convention: ``[approx | detail]`` halves on the
prefix, multi-level on the shrinking approximation.
"""
from __future__ import annotations

import torch

from ..utils.device import as_signal
from ..utils.validation import check_power_of_two, exponent

__all__ = ["cdf53", "icdf53", "cdf97", "icdf97", "lifting_fwt",
           "lifting_ifwt"]

# JPEG2000 9/7 lifting constants (Daubechies–Sweldens factorization)
_A = -1.5861343420693648
_B = -0.05298011857296141
_G = 0.8829110755411875
_D = 0.44350685204397454
_K = 1.2301741049140097


def _next(v):
    """v[i + 1], periodic."""
    return torch.roll(v, -1, dims=-1)


def _prev(v):
    """v[i − 1], periodic."""
    return torch.roll(v, 1, dims=-1)


def _merge(e, o):
    return torch.stack([e, o], dim=-1).reshape(e.shape[:-1]
                                               + (2 * e.shape[-1],))


def _cdf53_step(x):
    e, o = x[..., 0::2], x[..., 1::2]
    # predict: d[i] = o[i] − ½(e[i] + e[i+1]);  update: s[i] = e[i] +
    # ¼(d[i−1] + d[i])
    d = o - 0.5 * (e + _next(e))
    s = e + 0.25 * (_prev(d) + d)
    return torch.cat([s, d], dim=-1)


def _icdf53_step(y):
    half = y.shape[-1] // 2
    s, d = y[..., :half], y[..., half:]
    e = s - 0.25 * (_prev(d) + d)
    o = d + 0.5 * (e + _next(e))
    return _merge(e, o)


def _cdf97_step(x):
    e, o = x[..., 0::2], x[..., 1::2]
    d = o + _A * (e + _next(e))
    s = e + _B * (_prev(d) + d)
    d = d + _G * (s + _next(s))
    s = s + _D * (_prev(d) + d)
    return torch.cat([_K * s, d / _K], dim=-1)


def _icdf97_step(y):
    half = y.shape[-1] // 2
    s, d = y[..., :half] / _K, y[..., half:] * _K
    s = s - _D * (_prev(d) + d)
    d = d - _G * (s + _next(s))
    e = s - _B * (_prev(d) + d)
    o = d - _A * (e + _next(e))
    return _merge(e, o)


_STEPS = {"cdf53": (_cdf53_step, _icdf53_step),
          "cdf97": (_cdf97_step, _icdf97_step)}


def _widths(n: int, level) -> list[int]:
    """The widths the pyramid's levels act on, outermost first."""
    level = exponent(n) if level is None else level
    widths = []
    h = n
    while h >= 2 and len(widths) < level:
        widths.append(h)
        h //= 2
    return widths


def lifting_fwt(x: torch.Tensor, scheme: str = "cdf97", level=None
                ) -> torch.Tensor:
    """Multi-level lifting pyramid on the last axis (power-of-2 length)."""
    x = as_signal(x)
    n = x.shape[-1]
    check_power_of_two(n)
    fwd, _ = _STEPS[scheme]
    for h in _widths(n, level):
        head = fwd(x[..., :h])
        x = torch.cat([head, x[..., h:]], dim=-1) if h < n else head
    return x


def lifting_ifwt(y: torch.Tensor, scheme: str = "cdf97", level=None
                 ) -> torch.Tensor:
    """Inverse of :func:`lifting_fwt`: the levels' inverse steps, deepest
    first."""
    y = as_signal(y)
    n = y.shape[-1]
    check_power_of_two(n)
    _, inv = _STEPS[scheme]
    for h in reversed(_widths(n, level)):
        head = inv(y[..., :h])
        y = torch.cat([head, y[..., h:]], dim=-1) if h < n else head
    return y


def cdf53(x, level=None):
    """CDF 5/3 (LeGall) forward lifting transform."""
    return lifting_fwt(x, "cdf53", level)


def icdf53(y, level=None):
    return lifting_ifwt(y, "cdf53", level)


def cdf97(x, level=None):
    """CDF 9/7 (JPEG2000 irreversible) forward lifting transform."""
    return lifting_fwt(x, "cdf97", level)


def icdf97(y, level=None):
    return lifting_ifwt(y, "cdf97", level)
