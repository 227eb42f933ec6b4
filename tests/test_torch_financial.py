"""The port's market-data preprocessing (``ops/financial.py``) against the
JAX package's, on the CPU.

Inputs are numpy arrays from a seeded ``default_rng`` handed to both
packages; the JAX calls run under ``jax.jit`` (the median's bisection
compiles once per dtype and length, so the lengths repeat).  Tolerance at
float64: 1e-12 × max|ref| (the same arithmetic in another summation
order); the selections — ``median_select``, the gap fills — exactly equal,
bit for bit where the value is a number.  One reference caveat, not
copied: for the float64 row ``[5e-324, 1e-323, 2e-308, 0.0]`` XLA:CPU
flushes the mean of the two denormal middles to 0, where ``np.median`` and
the port give 1e-323.  The port's own properties are the JAX package's
(``tests/test_financial.py``).
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

jfin = importlib.import_module("jwave_pro_tpu.ops.financial")


@functools.lru_cache(maxsize=None)
def _jax(name, *static):
    return jax.jit(lambda *a: getattr(jfin, name)(*a, *static))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _rel_z(got, want):
    """:func:`_rel` for a normalized series z.  Where σ is 0 (a row's
    head, the returns after a leading gap) the divisor is the 1e-12
    floor, and z = r/1e-12 is a spike that would set max|ref| alone: each
    spike (|z| > 1e3) is held within 1e-12 of its own size, and the rest
    within 1e-12 of the rest's max|ref|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    spike = np.abs(want) > 1e3
    err = np.abs(got - want)
    return max(_rel(got[~spike], want[~spike]),
               float((err[spike] / np.abs(want[spike])).max(initial=0.0)))


def _bitwise(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    ints = {2: np.int16, 4: np.int32, 8: np.int64}[want.dtype.itemsize]
    np.testing.assert_array_equal(got[~nan].view(ints), want[~nan].view(ints))


def _prices(rng, shape):
    return np.exp(np.cumsum(0.01 * rng.standard_normal(shape), axis=-1)) * 50


# -- median_select -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 17, 100])
def test_median_select_matches_jax_bitwise(dtype, n):
    rng = np.random.default_rng(n)
    dense = rng.standard_normal((3, n)).astype(dtype) * 100
    ties = rng.integers(-3, 4, size=(3, n)).astype(dtype)
    zeros = np.where(rng.random((3, n)) < 0.5, 0.0, -0.0).astype(dtype)
    for x in (dense, ties, zeros):
        want = np.asarray(_jax("median_select")(x))
        _bitwise(jt.median_select(_t(x)), want)
        np.testing.assert_array_equal(want, np.median(x, axis=-1))


def test_median_select_axis_batch_and_nan_rows():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((7, 5))
    _bitwise(jt.median_select(_t(x), axis=0),
             _jax("median_select", 0)(x))
    xb = rng.standard_normal((2, 3, 64)).astype(np.float32)
    _bitwise(jt.median_select(_t(xb)), _jax("median_select")(xb))
    xn = rng.standard_normal((2, 9))
    xn[0, 3] = np.nan
    got = jt.median_select(_t(xn))
    _bitwise(got, _jax("median_select")(xn))
    assert np.isnan(_np(got)[0]) and _np(got)[1] == np.median(xn[1])


@pytest.mark.parametrize("row", [[1.0, np.inf, -np.inf, 2.0],
                                 [np.inf, np.inf, 1.0], [-np.inf, -np.inf],
                                 [3.0, 3.0, 3.0], [np.inf, -np.inf]])
def test_median_select_infinite_rows(row):
    x = np.array([row])
    _bitwise(jt.median_select(_t(x)), _jax("median_select")(x))


def test_median_select_overflows_as_jax():
    x = np.array([[3e38, 3e38], [-3e38, -3e38]], np.float32)
    want = np.asarray(_jax("median_select")(x))
    assert np.isposinf(want[0]) and np.isneginf(want[1])
    _bitwise(jt.median_select(_t(x)), want)


@pytest.mark.parametrize("n", [17, 100])
def test_median_select_bf16_as_jax(n):
    """bf16 is selected in f32 and the two middles cast back to bf16 before
    their mean, which rounds in bf16: the JAX package's value, bit for bit."""
    x = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    want = np.asarray(_jax("median_select")(jnp.asarray(x, jnp.bfloat16)))
    got = jt.median_select(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(
            _jax("median_select")(jnp.asarray(x, jnp.bfloat16)),
            jnp.int16)))


def test_median_select_denormal_caveat():
    """Reference caveat, not copied: the mean of the denormal middles
    5e-324 and 1e-323 is 1e-323 (round half to even), as ``np.median``
    gives; XLA:CPU flushes it to 0."""
    x = np.array([[5e-324, 1e-323, 2e-308, 0.0]])
    got = _np(jt.median_select(_t(x)))
    assert got[0] == 1e-323 == np.median(x[0])
    assert np.asarray(_jax("median_select")(x))[0] == 0.0


# -- fill_gaps, log returns ----------------------------------------------------

def _gappy(rng):
    x = rng.standard_normal((5, 64))
    x[0, [0, 1, 10, 11, 12, 63]] = np.nan          # leading, inner, trailing
    x[1, [5, 6]] = [np.inf, -np.inf]               # infinities are gaps too
    x[2, :] = np.nan                               # all-gap row
    x[3, [0]] = -np.inf
    return x


@pytest.mark.parametrize("method", ["ffill", "zero", "mean"])
def test_fill_gaps_matches_jax(method):
    x = _gappy(np.random.default_rng(5))
    want = np.asarray(_jax("fill_gaps", method)(x))
    got = jt.fill_gaps(_t(x), method)
    assert np.isfinite(_np(got)).all()
    if method == "mean":
        assert _rel(got, want) <= 1e-12
    else:
        _bitwise(got, want)
    np.testing.assert_array_equal(_np(got)[2], 0.0)


def test_fill_gaps_semantics_and_error():
    x = np.random.default_rng(5).standard_normal(64)
    x[[0, 1, 10, 11, 12, 63]] = np.nan
    f = _np(jt.fill_gaps(_t(x), "ffill"))
    assert f[0] == f[1] == x[2] and f[10] == f[11] == f[12] == x[9]
    assert f[63] == x[62]
    z = _np(jt.fill_gaps(_t(x), "zero"))
    assert (z[[0, 1, 10]] == 0).all() and z[2] == x[2]
    m = _np(jt.fill_gaps(_t(x), "mean"))
    np.testing.assert_allclose(m[0], np.nanmean(x), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown gap method"):
        jt.fill_gaps(_t(x), "bogus")
    with pytest.raises(ValueError):
        jw.fill_gaps(x, "bogus")


def test_log_returns_and_cumulate_match_jax():
    p = _prices(np.random.default_rng(5), (3, 256))
    r = jt.log_returns(_t(p), scale=100.0)
    assert _rel(r, _jax("log_returns", 100.0)(p)) <= 1e-12
    assert float(r[..., 0].abs().max()) == 0.0
    r1 = jt.log_returns(_t(p))
    back = jt.cumulate_returns(r1, _t(p[..., :1]))
    want = jw.cumulate_returns(np.asarray(jw.log_returns(p)), p[..., :1])
    assert _rel(back, want) <= 1e-12
    np.testing.assert_allclose(_np(back), p, rtol=1e-12)


# -- winsorize -----------------------------------------------------------------

def _same_clips(got, want, r):
    """Within 1e-12 of the JAX package's values (XLA folds the division
    by 0.6745 into a product, so an edge may differ in its last bit), and
    the same samples clipped."""
    assert _rel(got, want) <= 1e-12
    np.testing.assert_array_equal(_np(got) != r, np.asarray(want) != r)


def test_winsorize_matches_jax():
    rng = np.random.default_rng(9)
    r = 0.01 * rng.standard_normal((4, 512))
    r[0, 100] = 5.0
    r[1, 7] = -3.0
    r[2, ::3] = 0.0
    r[3, :300] = 0.0                               # MAD = 0: no clipping
    want = np.asarray(_jax("winsorize_outliers", 5.0)(r))
    got = jt.winsorize_outliers(_t(r), 5.0)
    _same_clips(got, want, r)
    np.testing.assert_array_equal(_np(got)[3], r[3])
    rt = r.T.copy()
    want0 = np.asarray(_jax("winsorize_outliers", 3.0, 0)(rt))
    _same_clips(jt.winsorize_outliers(_t(rt), 3.0, axis=0), want0, rt)


def test_winsorize_is_robust_to_the_outlier_itself():
    r = 0.01 * np.random.default_rng(5).standard_normal(512)
    r[100] = 5.0
    w = _np(jt.winsorize_outliers(_t(r), n_sigmas=5.0))
    assert abs(w[100]) < 0.2
    mask = np.ones(512, bool)
    mask[100] = False
    np.testing.assert_array_equal(w[mask], r[mask])


# -- EWMA and the volatility stages -------------------------------------------

@pytest.mark.parametrize("min_periods", [0, 10])
@pytest.mark.parametrize("lam", [0.0, 0.5, 0.94, 0.995])
def test_ewma_volatility_matches_jax_f64(lam, min_periods):
    """At float64 λ = 0.5 runs the JAX package's banded branch (53 taps)
    and λ = 0.94 (594 taps) and 0.995 (every one of the 1500 samples) its
    one-channel convolution; the port runs banded blocks for all."""
    r = 0.01 * np.random.default_rng(11).standard_normal((2, 1500))
    want = _jax("ewma_volatility", lam, min_periods)(r)
    assert _rel(jt.ewma_volatility(_t(r), lam, min_periods), want) <= 1e-12


@pytest.mark.parametrize("lam", [0.94, 0.995])
def test_ewma_volatility_f32_and_batch(lam):
    """float32 (269 taps at λ = 0.94: the banded branch in both packages)
    and a batch of two leading axes: within float32 summation noise."""
    r = (0.01 * np.random.default_rng(12).standard_normal((2, 3, 1100))
         ).astype(np.float32)
    want = np.asarray(_jax("ewma_volatility", lam, 10)(r))
    got = jt.ewma_volatility(_t(r), lam)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=2e-5)


def test_ewma_lam_edge_cases():
    r = _t(0.01 * np.random.default_rng(5).standard_normal(64))
    s0 = _np(jt.ewma_volatility(r, lam=0.0, min_periods=0))
    np.testing.assert_allclose(s0, np.abs(_np(r)), rtol=1e-12)
    for lam in (1.0, -0.1):
        with pytest.raises(ValueError, match="lam must be"):
            jt.ewma_volatility(r, lam=lam)
    si = jt.ewma_volatility(torch.arange(32), min_periods=0)
    want = np.asarray(jw.ewma_volatility(jnp.arange(32), min_periods=0))
    assert si.dtype == torch.float32 and (_np(si)[1:] > 0).all()
    np.testing.assert_allclose(_np(si), want, rtol=1e-5)


def test_ewma_is_strictly_causal_and_head_only_warmup():
    rng = np.random.default_rng(5)
    r = 0.01 * rng.standard_normal(256)
    r2 = r.copy()
    r2[200:] *= 50.0
    s1 = _np(jt.ewma_volatility(_t(r)))
    s2 = _np(jt.ewma_volatility(_t(r2)))
    np.testing.assert_allclose(s1[:200], s2[:200], rtol=1e-12)
    var0 = _np(jt.ewma_volatility(_t(r), min_periods=0)) ** 2
    t = np.arange(256)
    blend = np.minimum(t / 10.0, 1.0)
    want = np.sqrt(blend * var0 + (1 - blend) * np.cumsum(r * r) / (t + 1.0))
    np.testing.assert_allclose(s1, want, rtol=1e-12)


def test_normalize_volatility_matches_jax():
    rng = np.random.default_rng(13)
    r = np.concatenate([0.01 * rng.standard_normal((2, 800)),
                        0.05 * rng.standard_normal((2, 800))], axis=-1)
    for lam in (0.94, 0.97):
        z, sig = jt.normalize_volatility(_t(r), lam)
        wz, wsig = _jax("normalize_volatility", lam)(r)
        assert _rel_z(z, wz) <= 1e-12 and _rel(sig, wsig) <= 1e-12
    z = _np(z)
    assert 0.6 < np.std(z[0, 200:780]) < 1.7 and 0.6 < np.std(z[0, 900:]) < 1.7


def test_normalize_volatility_halted_session_floor():
    r = np.zeros(1024, np.float32)
    r[10], r[-1] = 0.05, 0.01
    z, _ = jt.normalize_volatility(_t(r))
    wz, _ = _jax("normalize_volatility")(r)
    z = _np(z)
    assert np.isfinite(z).all() and abs(z[-1]) < 1e7
    np.testing.assert_allclose(z, np.asarray(wz), rtol=1e-5)


@pytest.mark.parametrize("annualize", [None, 252.0])
def test_realized_volatility_matches_jax(annualize):
    r = np.random.default_rng(14).standard_normal((2, 1300))
    got = jt.realized_volatility(_t(r), 16, annualize)
    want = _jax("realized_volatility", 16, annualize)(r)
    assert _rel(got, want) <= 1e-12
    np.testing.assert_allclose(
        _np(got)[:, 63] / np.sqrt(annualize or 1.0),
        np.sqrt(np.sum(r[:, 48:64] ** 2, axis=-1)), rtol=1e-12)


def test_realized_volatility_bfloat16_keeps_the_dtype_in_both():
    """A reference caveat, copied: both packages take the running sum of
    r² in the input dtype and subtract its shifted copy, so in bfloat16
    the difference cancels.  Both return bfloat16, and at (4, 65536) with
    window 8 both are more than 100% of max off the float64 result of the
    same rounded returns."""
    r = np.random.default_rng(16).standard_normal((4, 65536))
    rb = torch.from_numpy(r.astype(np.float32)).to(torch.bfloat16)
    got = jt.realized_volatility(rb, 8)
    want = _jax("realized_volatility", 8, None)(
        jnp.asarray(rb.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ref = jt.realized_volatility(rb.double(), 8).numpy()
    for out in (got.double().numpy(), np.asarray(want, np.float64)):
        assert np.abs(out - ref).max() > np.abs(ref).max()


# -- the chain -----------------------------------------------------------------

@pytest.mark.parametrize("devolatize", [True, False])
@pytest.mark.parametrize("gap_method", ["ffill", "mean"])
def test_preprocess_prices_matches_jax(devolatize, gap_method):
    rng = np.random.default_rng(15)
    p = _prices(rng, (3, 1024))
    p[0, 100:110] = np.nan
    p[1, 500] = p[1, 499] * 3.0                   # an outlier jump
    p[2, :3] = np.nan                             # leading gap
    z, sig = jt.preprocess_prices(_t(p), gap_method, 5.0, devolatize)
    wz, wsig = _jax("preprocess_prices", gap_method, 5.0, devolatize)(p)
    assert _rel_z(z, wz) <= 1e-12 and _rel(sig, wsig) <= 1e-12
    assert np.isfinite(_np(z)).all()
    nu2 = jt.modwt_variance(z, jt.wavelet("Daubechies 4"), 4)
    assert np.isfinite(_np(nu2)).all() and (_np(nu2) > 0).all()
