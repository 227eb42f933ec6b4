"""Market-data preprocessing for wavelet analysis, in PyTorch.

Counterpart of ``jwave_pro_tpu/ops/financial.py``; same semantics and
names.  The reference's ``docs/FINANCIAL_ROADMAP.md:29-120`` proposes a
``FinancialWaveletTransform`` whose forward pass runs a preprocessing
chain — gap handling, volatility normalization, outlier detection — before
the MODWT.  Here, as in the JAX package, each stage is a function that
batches over leading axes and feeds any transform of the library.

Conventions: prices are ``(..., N)`` with time on the last axis; a
non-finite value marks a gap.  The chain ``log_returns → fill_gaps →
winsorize_outliers → normalize_volatility`` emits gap-free output.

Where the JAX package works around the TPU, the port takes the direct
form with the same result: the median is an exact selection by sorting
order keys (the JAX package bisects them, a TPU trick), gaps are filled
by a running maximum of the last finite index, and the prefix sums are
``torch.cumsum``.  The EWMA's exponential FIR runs as banded block
products through the pinned product (``ops/fwt.py:_mm``, IEEE float32 on
the card, as the JAX package runs them at ``Precision.HIGHEST``); the
long-memory λ, where the JAX package takes a one-channel convolution, uses
more of the same blocks, so no product of the chain follows the process's
TF32 setting.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import as_input, as_signal
from .fwt import _mm, _on

__all__ = [
    "log_returns", "cumulate_returns", "fill_gaps", "median_select",
    "winsorize_outliers", "ewma_volatility", "normalize_volatility",
    "realized_volatility", "preprocess_prices",
]


def log_returns(prices: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``scale·(ln p[t] − ln p[t−1])`` with r[0] = 0 — length-preserving,
    so every transform of the library takes the N the prices had.  A gap
    gives a NaN return at both affected lags (fill it afterwards)."""
    lp = torch.log(as_signal(prices))
    return torch.diff(lp, dim=-1, prepend=lp[..., :1]) * scale


def cumulate_returns(returns: torch.Tensor, p0=1.0,
                     scale: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`log_returns`: ``p0·exp(cumsum(r/scale))``, so
    ``cumulate_returns(log_returns(p), p[..., :1])`` gives ``p`` back."""
    r = as_signal(returns) / scale
    if not isinstance(p0, (int, float, torch.Tensor)):
        p0 = torch.as_tensor(p0, device=r.device)
    return p0 * torch.exp(torch.cumsum(r, dim=-1))


def fill_gaps(x: torch.Tensor, method: str = "ffill") -> torch.Tensor:
    """Replace every non-finite value (NaN or ±inf): ``'ffill'`` carries
    the last finite value forward (leading gaps take the first finite
    value, an all-gap row zeros), ``'zero'`` puts 0 (right for RETURNS — a
    halted market realizes no return), ``'mean'`` the row's mean of its
    finite values."""
    x = as_input(x)
    finite = torch.isfinite(x)
    if method == "zero":
        return torch.where(finite, x, 0.0)
    if method == "mean":
        cnt = finite.sum(-1, keepdim=True).clamp_min(1)
        mean = torch.where(finite, x, 0.0).sum(-1, keepdim=True) / cnt
        return torch.where(finite, x, mean)
    if method != "ffill":
        raise ValueError(f"unknown gap method {method!r}")
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device).expand(x.shape)
    # index of the last finite sample at or before t (-1 before the first)
    last = torch.cummax(torch.where(finite, pos, -1), dim=-1).values
    carried = torch.gather(x, -1, last.clamp_min(0))
    first_idx = torch.argmax(finite.to(torch.int8), dim=-1, keepdim=True)
    first = torch.gather(x, -1, first_idx)
    first = torch.where(torch.isfinite(first), first, 0.0)
    return torch.where(last >= 0, carried, first)


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """Signed integers whose order is the float order of ``x`` (float32 or
    float64), −0 below +0: a negative float's magnitude bits are flipped.
    The map is its own inverse (:func:`_keys_to_float`)."""
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    u = x.view(ints)
    mask = (1 << (torch.iinfo(ints).bits - 1)) - 1
    return torch.where(u < 0, u ^ mask, u)


def _keys_to_float(k: torch.Tensor) -> torch.Tensor:
    mask = (1 << (torch.iinfo(k.dtype).bits - 1)) - 1
    b = torch.where(k < 0, k ^ mask, k)
    return b.view(torch.float64 if k.dtype == torch.int64 else torch.float32)


def median_select(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exact median along ``axis`` with ``jnp.median``'s semantics as the
    JAX package's ``median_select`` gives them: the mean of the two
    middles for an even length (in the input's dtype, so it may overflow
    to inf), NaN for a row that holds a NaN; bfloat16 and float16 are
    selected in float32 and cast back before the mean.

    The middles are picked from the sorted order keys of the values (the
    JAX package's key map, so −0 sorts below +0, and the pick is the JAX
    package's value bit for bit)."""
    x = as_input(x)
    if axis % x.ndim != x.ndim - 1:
        x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    wide = x if x.dtype in (torch.float32, torch.float64) else \
        x.to(torch.float32)
    keys = torch.sort(_order_keys(wide), dim=-1).values
    lo = _keys_to_float(keys[..., (n - 1) // 2]).to(x.dtype)
    if n % 2:
        med = lo
    else:
        med = (lo + _keys_to_float(keys[..., n // 2]).to(x.dtype)) / 2
    return torch.where(torch.isnan(x).any(-1), torch.nan, med)


def winsorize_outliers(r: torch.Tensor, n_sigmas: float = 5.0,
                       axis: int = -1) -> torch.Tensor:
    """Clip returns to ``median ± n_sigmas·σ`` along ``axis``, σ the robust
    MAD/0.6745 (immune to the outliers being clipped).  A window whose MAD
    is 0 (more than half its values equal) is not clipped; NaN input gives
    NaN output (run :func:`fill_gaps` first)."""
    r = as_input(r)
    med = median_select(r, axis=axis).unsqueeze(axis)
    sigma = median_select(torch.abs(r - med), axis=axis).unsqueeze(
        axis) / 0.6745
    lim = torch.where(sigma > 0, n_sigmas * sigma, torch.inf)
    return torch.minimum(torch.maximum(r, med - lim), med + lim)


_FIR_BLK = 512


@functools.lru_cache(maxsize=32)
def _fir_block_constants(lam: float, k_taps: int):
    """The (BLK, BLK) blocks of the exponential FIR's banded Toeplitz
    matrix, host float64: block j maps the input block j back to an output
    block, ``block_j[u, t] = taps[t − u + j·BLK]`` where that tap exists.
    Blocks 0 and 1 are the JAX package's ``cur`` and ``prev`` constants;
    more blocks carry a longer memory."""
    taps = (1.0 - lam) * lam ** np.arange(k_taps)
    diff = np.arange(_FIR_BLK)[None, :] - np.arange(_FIR_BLK)[:, None]
    blocks = []
    for j in range(-(-(k_taps + _FIR_BLK - 1) // _FIR_BLK)):
        k = diff + j * _FIR_BLK
        ok = (k >= 0) & (k < k_taps)
        blocks.append(np.where(ok, taps[np.clip(k, 0, k_taps - 1)], 0.0))
    return tuple(blocks)


def _mantissa_bits(dtype: torch.dtype) -> int:
    return round(-math.log2(torch.finfo(dtype).eps)) + 1


def ewma_volatility(r: torch.Tensor, lam: float = 0.94,
                    min_periods: int = 10) -> torch.Tensor:
    """RiskMetrics EWMA volatility: ``σ²[t] = λ·σ²[t−1] + (1−λ)·r²[t]``,
    strictly causal: seeded at r[0]², the first ``min_periods`` steps
    blended toward the expanding mean of r²[:t+1].

    The recursion unrolls to an exponential FIR truncated at the
    K = ⌈−mant·ln2/lnλ⌉ taps the dtype resolves, plus the λ^{t+1}·r²[0]
    seed term, computed as banded block products through the pinned
    product.
    """
    if not 0.0 <= lam < 1.0:
        raise ValueError(f"lam must be in [0, 1), got {lam}")
    r = as_input(r)
    if not r.is_floating_point():
        r = r.to(torch.float32)
    n = r.shape[-1]
    r2 = r * r
    if lam == 0.0:
        k_taps = 1                                 # v[t] = r²[t]
    else:
        k_taps = int(min(n, np.ceil(-_mantissa_bits(r.dtype) * np.log(2.0)
                                    / np.log(lam))))
        k_taps = max(k_taps, 1)
    lead = r2.shape[:-1]
    npad = (-n) % _FIR_BLK
    kb = (n + npad) // _FIR_BLK
    xb = torch.nn.functional.pad(r2, (0, npad)).reshape(
        lead + (kb, _FIR_BLK))
    var = None
    blocks = _on(_fir_block_constants, (lam, k_taps), r2.dtype, r2.device)
    for j, block in enumerate(blocks[:kb]):
        src = xb if j == 0 else torch.cat(
            [xb.new_zeros(lead + (j, _FIR_BLK)), xb[..., :kb - j, :]], dim=-2)
        term = _mm(src, block)
        var = term if var is None else var + term
    var = var.reshape(lead + (n + npad,))[..., :n]
    if lam > 0.0:
        # seed: v[0] = r²[0] exactly (strictly causal) ⇒ add λ^{t+1}·r²[0]
        t_idx = torch.arange(n, dtype=r.dtype, device=r.device)
        var = var + torch.exp((t_idx + 1.0) * float(np.log(lam))) \
            * r2[..., :1]
    if min_periods > 0:
        # the blend is 1 from t = min_periods on: only the head reads the
        # expanding mean
        head = min(min_periods, n)
        t = torch.arange(head, dtype=r.dtype, device=r.device)
        blend = t / float(min_periods)
        var_exp = torch.cumsum(r2[..., :head], dim=-1) / (t + 1.0)
        var = torch.cat([blend * var[..., :head] + (1.0 - blend) * var_exp,
                         var[..., head:]], dim=-1)
    return torch.sqrt(var)


def _lag(a: torch.Tensor) -> torch.Tensor:
    """``a`` one step later along the last axis, its first value kept."""
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def normalize_volatility(r: torch.Tensor, lam: float = 0.94,
                         eps: float = 1e-12, rel_floor: float = 1e-3):
    """Devolatize returns: ``z[t] = r[t]/σ[t−1]`` (σ lagged one step, so
    the normalizer is strictly causal); returns ``(z, sigma)``.

    The divisor is floored at ``eps + rel_floor·(causal expanding RMS)``,
    so that after a long flat stretch (σ decayed toward 0) the first
    resumed return is amplified at most ``1/rel_floor`` times the series'
    own running scale.
    """
    r = as_input(r)
    if not r.is_floating_point():
        r = r.to(torch.float32)
    sigma = ewma_volatility(r, lam)
    t = torch.arange(r.shape[-1], dtype=r.dtype, device=r.device)
    rms_exp = torch.sqrt(torch.cumsum(r * r, dim=-1) / (t + 1.0))
    floor = eps + rel_floor * _lag(rms_exp)
    return r / torch.maximum(_lag(sigma), floor), sigma


def realized_volatility(r: torch.Tensor, window: int,
                        annualize: float | None = None) -> torch.Tensor:
    """Rolling realized volatility ``√(Σ_window r²)`` per step (same
    length; the first ``window−1`` entries use the partial sum).
    ``annualize``: multiply by ``√annualize`` (e.g. 252 for daily bars).
    """
    r = as_input(r)
    n = r.shape[-1]
    c = torch.cumsum(r * r, dim=-1)
    shifted = torch.nn.functional.pad(c, (window, 0))[..., :n]
    rv = torch.sqrt(torch.clamp_min(c - shifted, 0.0))
    if annualize is not None:
        rv = rv * math.sqrt(annualize)
    return rv


def preprocess_prices(prices: torch.Tensor, gap_method: str = "ffill",
                      n_sigmas: float = 5.0, devolatize: bool = True,
                      lam: float = 0.94):
    """The roadmap's whole preprocessing chain in one call: gap-fill
    prices → log returns → winsorize outliers → (optionally) devolatize.

    Returns ``(z, sigma)`` (``sigma`` the EWMA scale, or ones when
    ``devolatize=False``), ready for ``modwt``, ``modwt_variance`` or any
    other transform of the library.
    """
    p = fill_gaps(prices, gap_method)
    r = winsorize_outliers(log_returns(p), n_sigmas)
    if devolatize:
        return normalize_volatility(r, lam)
    return r, torch.ones_like(r)
