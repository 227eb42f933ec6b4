"""The port's synchrosqueezed CWT against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* ``ssq_cwt`` at f64: Tx and Wx 1e-12 relative to max|ref| (the same host
  float64 multipliers, float64 irffts in another order, the scatter's
  sums in another order); the bins each coefficient lands in exact (the
  same float64 ratio, log and round-half-to-even: Tx's support compared
  as a mask); ``ssq_freqs`` and ``scales`` exact.
* ``issq_cwt`` whole and band-masked, 1e-12 relative.
* ``tests/golden/regression.npz`` at the JAX package's own bounds
  (``tests/test_golden.py``): ``ssq_Tx`` atol 1e-10, ``ssq_freqs`` rtol
  1e-12, ``ridge_indices`` exact.
* The JAX package's TPU front end — ``_reassign_planes`` fed by
  ``cwt_banded_wd`` — against the port's same two functions, 1e-12
  relative (both banded paths run float64 products).
* float32 input: 1e-5 relative to the f64 result where the bins agree.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

jssq = importlib.import_module("jwave_pro_tpu.ops.ssq")
jbanded = importlib.import_module("jwave_pro_tpu.ops.cwt_banded")
tssq = importlib.import_module("jwave_pro_tpu_torch.ops.ssq")
tcwt = importlib.import_module("jwave_pro_tpu_torch.ops.cwt")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _chirps(rng, shape, fs=256.0):
    """Two tones and a chirp plus noise: ridges that reassignment sharpens."""
    n = shape[-1]
    t = np.arange(n) / fs
    base = (np.sin(2 * np.pi * 20.0 * t) + 0.6 * np.sin(
        2 * np.pi * (40.0 * t + 30.0 * t * t)))
    return base + 0.1 * rng.standard_normal(shape)


def _scales(num=24):
    """Scales in seconds for bins from 5 to 100 Hz (f = fc/a)."""
    fc = jt.MorletWavelet().center_frequency
    return jt.generate_log_scales(fc / 100.0, fc / 5.0, num)


def _jax_result(x, scales, **kw):
    """The JAX package's SSQResult, its arrays from one jitted call."""
    arrays = jax.jit(lambda v: jw.ssq_cwt(v, scales, **kw)[:5])(
        jnp.asarray(x))
    return jssq.SSQResult(*arrays, kw.get("sampling_rate", 1.0),
                          jw.MorletWavelet().name)


def _jax_ssq(x, scales, **kw):
    res = _jax_result(x, scales, **kw)
    return [np.asarray(a) for a in res[:5]] + [res.sampling_rate,
                                               res.wavelet_name]


CASES = [
    ((2, 300), dict(sampling_rate=256.0)),
    ((300,), dict(sampling_rate=256.0, gamma=1e-3)),
    ((2, 2, 256), dict(sampling_rate=256.0, n_freqs=40)),
    ((2, 256), dict(sampling_rate=256.0, freq_range=(8.0, 90.0),
                    padding="symmetric")),
]


@pytest.mark.parametrize("shape,kw", CASES)
def test_ssq_cwt_matches_jax_f64(shape, kw):
    x = _chirps(np.random.default_rng(0), shape)
    scales = _scales()
    want = _jax_ssq(x, scales, **kw)
    got = jt.ssq_cwt(torch.from_numpy(x), scales, **kw)
    assert got.Tx.dtype == torch.complex128 and got.Wx.dtype == \
        torch.complex128
    assert tuple(got.Tx.shape) == want[0].shape
    assert _rel(got.Tx.numpy(), want[0]) <= 1e-12
    assert _rel(got.Wx.numpy(), want[1]) <= 1e-12
    # every coefficient lands in the same bin: the supports agree exactly
    np.testing.assert_array_equal(got.Tx.numpy() != 0, want[0] != 0)
    np.testing.assert_array_equal(got.ssq_freqs.numpy(), want[2])
    np.testing.assert_array_equal(got.scales.numpy(), want[3])
    np.testing.assert_array_equal(got.time_axis.numpy(), want[4])
    assert (got.sampling_rate, got.wavelet_name) == (want[5], want[6])
    assert _rel(got.magnitude.numpy(), np.abs(want[0])) <= 1e-12
    assert _rel(got.energy_profile.numpy(),
                np.sum(np.abs(want[0]) ** 2, axis=-1)) <= 1e-12


def _planes(x, scales, fs):
    """The irfft front end's (W, ∂_t W) quadrature planes of ``x``."""
    n = x.shape[-1]
    p = jt.next_power_of_two(n)
    mults = tssq._ssq_multipliers(jt.MorletWavelet(), tuple(scales), p, fs)
    return tssq._ssq_planes(jt.pad_signal(x, p), n, mults, torch.float64,
                            torch.complex128)


@pytest.mark.parametrize("gamma", [None, 0.0])
def test_sum_over_bins_is_the_weighted_sum_of_the_reassigned(gamma):
    """Σ_bins Tx = Σ_a w_a·W over the reassigned coefficients, whichever
    bins they went to."""
    x = torch.from_numpy(_chirps(np.random.default_rng(1), (2, 512)))
    scales = [float(s) for s in _scales()]
    fc = jt.MorletWavelet().center_frequency
    log_lo = math.log(fc / max(scales))
    dlog = (math.log(fc / min(scales)) - log_lo) / (len(scales) - 1)
    res = jt.ssq_cwt(x, scales, sampling_rate=256.0, gamma=gamma)
    _, valid, _ = tssq._bins(*_planes(x, scales, 256.0), log_lo, dlog,
                             len(scales), gamma, torch.float64)
    assert 0 < float(valid.double().mean()) < 1
    w = torch.from_numpy(tssq._ssq_weights(tuple(scales)))
    lhs = res.Tx.sum(dim=-2)
    rhs = (w[:, None] * res.Wx * valid).sum(dim=-2)
    assert float((lhs - rhs).abs().max() / rhs.abs().max()) <= 1e-12


@pytest.mark.parametrize("band", [None, (15.0, 28.0)])
def test_issq_cwt_matches_jax_f64(band):
    x = _chirps(np.random.default_rng(2), (2, 512))
    scales = _scales(num=32)
    rj = _jax_result(x, scales, sampling_rate=256.0)
    rt = jt.ssq_cwt(torch.from_numpy(x), scales, sampling_rate=256.0)
    want = np.asarray(jw.issq_cwt(rj, freq_range=band))
    got = jt.issq_cwt(rt, freq_range=band)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-12
    got2 = jt.issq_cwt(rt, freq_range=band, scales=scales)
    assert _rel(got2.numpy(), want) <= 1e-12


def test_golden_regression_pins(golden_regression):
    g = golden_regression
    res = jt.ssq_cwt(torch.from_numpy(g["input_512"]), g["ssq_scales"],
                     sampling_rate=256.0, gamma=1e-6)
    np.testing.assert_allclose(res.Tx.numpy(), g["ssq_Tx"], atol=1e-10)
    np.testing.assert_allclose(res.ssq_freqs.numpy(), g["ssq_freqs"],
                               rtol=1e-12)
    rid = jt.extract_ridges(res.Tx, res.ssq_freqs, n_ridges=2, mask_width=2)
    np.testing.assert_array_equal(rid.indices.numpy(), g["ridge_indices"])


@pytest.fixture(scope="module")
def golden_regression():
    import pathlib
    return np.load(pathlib.Path(__file__).parent / "golden" /
                   "regression.npz")


@pytest.mark.parametrize("gamma", [None, 1e-3])
def test_tpu_front_end_reassign_planes_matches_jax(gamma):
    """The JAX package's TPU branch: ``cwt_banded_wd`` feeds
    ``_reassign_planes``; the port's same two functions agree."""
    x = _chirps(np.random.default_rng(3), (2, 1000))
    scales = np.asarray(_scales())
    n, p, fs = 1000, 1024, 256.0
    wav_j, wav_t = jw.MorletWavelet(), jt.MorletWavelet()
    fc = wav_t.center_frequency
    log_lo = math.log(fc / scales.max())
    dlog = (math.log(fc / scales.min()) - log_lo) / (len(scales) - 1)
    weights = tcwt._icwt_weights(scales)
    xp = np.concatenate([x, np.zeros((2, p - n))], axis=-1)
    jw_c, jd_c = jbanded.cwt_banded_wd(
        jnp.fft.rfft(jnp.asarray(xp), axis=-1), n, scales, wav_j, fs, p)
    jtx, jwc = jssq._reassign_planes(
        jnp.real(jw_c), jnp.imag(jw_c), jnp.real(jd_c), jnp.imag(jd_c),
        weights, log_lo, dlog, len(scales), gamma, jnp.float64,
        jnp.complex128)
    tw_c, td_c = jt.cwt_banded_wd(torch.fft.rfft(torch.from_numpy(xp)), n,
                                  scales, wav_t, fs, p)
    ttx, twc = tssq._reassign_planes(
        tw_c.real, tw_c.imag, td_c.real, td_c.imag, weights, log_lo, dlog,
        len(scales), gamma, torch.float64, torch.complex128)
    assert _rel(twc.numpy(), jwc) <= 1e-12
    assert _rel(ttx.numpy(), jtx) <= 1e-12
    np.testing.assert_array_equal(ttx.numpy() != 0, np.asarray(jtx) != 0)
    # and the banded planes reassign like the irfft front end's
    res = jt.ssq_cwt(torch.from_numpy(x), scales, sampling_rate=fs,
                     gamma=gamma)
    assert _rel(ttx.numpy(), res.Tx.numpy()) <= 1e-6


def test_dtype_table_against_jax():
    rng = np.random.default_rng(4)
    x = _chirps(rng, (2, 256)) * 10
    scales = _scales(num=8)
    x64 = _jax_ssq(x, scales, sampling_rate=256.0)
    for dt in (np.float32, np.float64, np.int32):
        xn = x.astype(dt)
        want = _jax_result(xn, scales, sampling_rate=256.0)
        got = jt.ssq_cwt(torch.from_numpy(xn), scales, sampling_rate=256.0)
        for g, w in zip(got[:5], want[:5]):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), dt
        back = jt.issq_cwt(got)
        assert str(back.dtype).split(".")[-1] == str(
            jw.issq_cwt(want).dtype)
        if dt == np.float32:
            # where f32 and f64 pick the same bin, Tx agrees to f32 noise
            same = (got.Tx.numpy() != 0) == (x64[0] != 0)
            err = np.abs(got.Tx.numpy() - x64[0])[same].max()
            assert err / np.abs(x64[0]).max() <= 1e-5
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = jt.ssq_cwt(xb, scales, sampling_rate=256.0)
    want = _jax_result(jnp.asarray(x, jnp.bfloat16), scales,
                       sampling_rate=256.0)
    assert got.Tx.dtype == torch.complex64 and str(want.Tx.dtype) == \
        "complex64"


def test_float16_input_is_wider_than_jax():
    """Float16 input: the JAX package raises ``ValueError`` (its rfft
    takes float32 or float64 only); the port computes in float32, as for
    bfloat16.  Against the JAX package's float64 result on the same
    rounded input: Wx within 1e-5 relative, Tx within 1e-5 relative where
    both pick the same bin (the float32 rows above)."""
    x16 = (_chirps(np.random.default_rng(6), (2, 256)) * 10).astype(
        np.float16)
    scales = _scales(num=8)
    with pytest.raises(ValueError, match="float32 or float64"):
        jw.ssq_cwt(jnp.asarray(x16), scales, sampling_rate=256.0)
    want = _jax_ssq(x16.astype(np.float64), scales, sampling_rate=256.0)
    got = jt.ssq_cwt(torch.from_numpy(x16), scales, sampling_rate=256.0)
    assert got.Tx.dtype == torch.complex64 and got.Wx.dtype == \
        torch.complex64
    assert _rel(got.Wx.numpy(), want[1]) <= 1e-5
    same = (got.Tx.numpy() != 0) == (want[0] != 0)
    assert same.mean() > 0.99
    err = np.abs(got.Tx.numpy() - want[0])[same].max()
    assert err / np.abs(want[0]).max() <= 1e-5
    back = jt.issq_cwt(got)
    assert back.dtype == torch.float32


def test_validation_errors_match_jax():
    x = np.random.default_rng(5).standard_normal((2, 128))
    scales = _scales(num=8)
    bad = [
        (lambda p, v: p.ssq_cwt(v + 1j * v, scales), ValueError),
        (lambda p, v: p.ssq_cwt(v, -scales), ValueError),
        (lambda p, v: p.ssq_cwt(v, scales, n_freqs=1), ValueError),
        (lambda p, v: p.ssq_cwt(v, scales, freq_range=(5.0, 1.0)),
         ValueError),
        (lambda p, v: p.ssq_cwt(v, scales, precision="fastest"),
         ValueError),
        (lambda p, v: p.issq_cwt(p.ssq_cwt(v, scales),
                                 freq_range=(10.0, 11.0)), ValueError),
    ]
    for fn, exc in bad:
        with pytest.raises(exc):
            fn(jw, jnp.asarray(x))
        with pytest.raises(exc):
            fn(jt, torch.from_numpy(x))
    for tier in (None, "highest", "high", "default"):
        jt.ssq_cwt(torch.from_numpy(x), scales, precision=tier)
    with pytest.raises(ValueError, match="STATIC"):
        jt.ssq_cwt(torch.from_numpy(x),
                   torch.from_numpy(scales).requires_grad_())


def test_round_half_to_even_bins():
    """A bin index exactly between two centres goes to the even one, as
    ``jnp.round`` sends it."""
    n_freqs, log_lo, dlog = 8, 0.0, 1.0
    f = np.exp(np.array([[0.5, 1.5, 2.5, 3.5]]))    # idx_f at half-integers
    w_re = torch.ones((1, 4), dtype=torch.float64)
    w_im = torch.zeros_like(w_re)
    d_re = torch.zeros_like(w_re)
    d_im = torch.from_numpy(2 * np.pi * f)          # ω = Im(∂W/W)
    tx, _ = tssq._reassign_planes(w_re, w_im, d_re, d_im, np.ones(1),
                                  log_lo, dlog, n_freqs, None,
                                  torch.float64, torch.complex128)
    rows = tx.real.argmax(dim=0).tolist()
    idx_f = (np.log(f[0]) - log_lo) / dlog
    assert rows == [int(r) for r in np.round(idx_f)]
