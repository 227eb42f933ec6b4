"""The port's MODWT statistics against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 statistics, 1e-12 absolute: both run the same float64 arithmetic on
  the same MODWT rows; only summation order (means, cumulative sums)
  differs, ~1e-16 relative at these sizes.  Hurst exponents pass through
  log2 of the variances, still far inside 1e-12.
* the variance kernel's plain version against the JAX Pallas kernel in
  interpret mode, f32, relative 1e-5: both compute the cascade and the sums
  in f32 in a different order (the on-chip bound of the JAX package's TPU
  smoke is 1e-4; the CPU runs agree tighter).  bf16 input is read as bf16
  and computed in f32 by both, so the same bound holds.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.variance_pallas import (
    modwt_var_fused as jax_var_fused,
)
from jwave_pro_tpu_torch.kernels import variance_cuda as kv
from jwave_pro_tpu_torch.ops import analysis as port_analysis

DB4 = "Daubechies 4"
WAVELETS = [DB4, "Symlet 8", "Haar"]


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax(fn, **static):
    """JIT a JAX statistic once per static arguments."""
    return jax.jit(functools.partial(getattr(jw, fn), **static))


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
@pytest.mark.parametrize("estimator", ["biased", "unbiased"])
@pytest.mark.parametrize("name", WAVELETS)
def test_variance_matches_jax_f64(name, estimator, boundary):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    rng = np.random.default_rng(WAVELETS.index(name))
    for shape, level in (((2, 200), 3), ((256,), 2)):
        x = rng.standard_normal(shape)
        kw = dict(wavelet=wj, level=level, method="direct",
                  estimator=estimator, boundary=boundary)
        want = _jax("modwt_variance", **kw)(x)
        got = jt.modwt_variance(_t(x), wt, level, method="direct",
                                estimator=estimator, boundary=boundary)
        assert got.dtype == torch.float64 and got.shape == want.shape
        _close(got, want)


@pytest.mark.parametrize("estimator,boundary", [
    ("unbiased", "periodic"), ("biased", "periodic"), ("unbiased", "reflect"),
])
def test_variance_ci_matches_jax_f64(estimator, boundary):
    x = np.random.default_rng(3).standard_normal((2, 300))
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = _jax("modwt_variance_ci", wavelet=wj, level=4, confidence=0.9,
                method="direct", estimator=estimator, boundary=boundary)(x)
    got = jt.modwt_variance_ci(_t(x), wt, 4, confidence=0.9, method="direct",
                               estimator=estimator, boundary=boundary)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    np.testing.assert_array_equal(got.edf, want.edf)
    assert bool(torch.all(got.lower <= got.variance))
    assert bool(torch.all(got.variance <= got.upper))


@pytest.mark.parametrize("name", [DB4, "Haar"])
def test_covariance_correlation_cross_correlation_match_jax_f64(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 160))
    y = 0.6 * x + rng.standard_normal((2, 160))
    for fn in ("modwt_covariance", "modwt_correlation"):
        want = _jax(fn, wavelet=wj, level=3, method="direct")(x, y)
        got = getattr(jt, fn)(_t(x), _t(y), wt, 3, method="direct")
        _close(got, want)
    want = _jax("modwt_cross_correlation", wavelet=wj, level=3, max_lag=4,
                method="direct")(x, y)
    got = jt.modwt_cross_correlation(_t(x), _t(y), wt, 3, 4, method="direct")
    assert got.shape == (3, 9, 2)
    _close(got, want)
    # different shapes: no polarization, the coefficient path
    want = _jax("modwt_covariance", wavelet=wj, level=3)(x, y[:1])
    _close(jt.modwt_covariance(_t(x), _t(y[:1]), wt, 3), want)


@pytest.mark.parametrize("kind", ["fgn", "fbm"])
@pytest.mark.parametrize("weighted", [True, False])
def test_hurst_matches_jax_f64(kind, weighted):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 1024))
    if kind == "fbm":
        x = np.cumsum(x, axis=-1)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    kw = dict(min_level=2, max_level=5, kind=kind, weighted=weighted,
              method="direct")
    want = _jax("modwt_hurst", wavelet=wj, level=6, return_fit=True,
                **kw)(x)
    got = jt.modwt_hurst(_t(x), wt, 6, return_fit=True, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    h = jt.modwt_hurst(_t(x), wt, 6, **kw)
    _close(h, want[0])
    # white noise → H ≈ 1/2, random walk levels → H ≈ 1/2
    assert np.all(np.abs(h.numpy() - 0.5) < 0.15)


def test_scale_energies_match_jax():
    rng = np.random.default_rng(2)
    c = rng.standard_normal((4, 3, 50))
    _close(jt.scale_energies(_t(c)), jw.scale_energies(c))
    z = c + 1j * rng.standard_normal(c.shape)
    got = jt.scale_energies(_t(z))
    assert not got.is_complex()
    _close(got, jw.scale_energies(z))


def test_changepoints_match_jax_f64():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 512))
    x[:, 300:] *= 3.0                                 # variance break at 300
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    for alpha in (0.05, 0.01):
        want = _jax("modwt_changepoints", wavelet=wj, level=3,
                    method="direct", alpha=alpha)(x)
        got = jt.modwt_changepoints(_t(x), wt, 3, method="direct",
                                    alpha=alpha)
        _close(got.d, want.d)
        _close(got.critical, want.critical)
        assert got.locations.dtype == torch.int32
        np.testing.assert_array_equal(got.locations.numpy(),
                                      np.asarray(want.locations))
        np.testing.assert_array_equal(got.significant.numpy(),
                                      np.asarray(want.significant))
    assert bool(got.significant[0].all())
    assert np.all(np.abs(got.locations[0].numpy() - 300) < 16)


def test_auto_matches_jax_f64_and_bf16_stays_coefficient_path():
    x = np.random.default_rng(6).standard_normal((2, 300))
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    _close(jt.modwt_variance(_t(x), wt, 3),
           _jax("modwt_variance", wavelet=wj, level=3)(x))
    # on the CPU 'auto' never takes the kernel: bf16 stays bf16, as in JAX
    x16 = _t(x.astype(np.float32)).bfloat16()
    assert port_analysis._try_var_fused(x16, wt, 3, "auto") is None
    assert jt.modwt_variance(x16, wt, 3).dtype == torch.bfloat16


@pytest.mark.parametrize("shape,level,dtype", [
    ((8, 2048), 3, np.float32),     # the JAX kernel tests' base shape
    ((8, 1001), 2, np.float32),     # odd N (the JAX kernel pads and masks)
    ((8192,), 3, np.float32),       # the 1D contract
    ((8, 2048), 3, "bfloat16"),     # bf16 read, f32 computed and returned
])
def test_var_plain_matches_jax_interpret(shape, level, dtype):
    x = np.random.default_rng(level).standard_normal(shape).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = _t(x).bfloat16() if dtype == "bfloat16" else _t(x)
    want = np.asarray(jax_var_fused(xj, jw.wavelet(DB4), level,
                                    interpret=True))
    got = kv.modwt_var_fused(xt, jt.wavelet(DB4), level)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_fused_method_and_polarization_match_jax():
    """``method='fused'`` on the CPU: the plain version here, the Pallas
    kernel in interpret mode there; covariance by polarization."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 2048)).astype(np.float32)
    y = (0.5 * x + rng.standard_normal((4, 2048))).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jw.modwt_variance(x, wj, 3, method="fused"))
    got = jt.modwt_variance(_t(x), wt, 3, method="fused")
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # polarization in f32 cancels: bound it by the variances' scale
    want = np.asarray(jw.modwt_covariance(x, y, wj, 3, method="fused"))
    got = jt.modwt_covariance(_t(x), _t(y), wt, 3, method="fused")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    direct = jt.modwt_covariance(_t(x).double(), _t(y).double(), wt, 3,
                                 method="direct")
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)
    rho = jt.modwt_correlation(_t(x), _t(y), wt, 3, method="fused")
    assert bool(torch.all(rho.abs() <= 1.0))


def test_var_plain_is_the_mean_of_squared_coefficients():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 500)))
    w = jt.wavelet(DB4)
    c = jt.modwt(x, w, 4, method="direct")
    torch.testing.assert_close(kv.modwt_var_plain(x, w, 4),
                               torch.mean(c * c, dim=-1), rtol=0, atol=1e-14)
    # biased rows partition the sample variance (energy preservation)
    v = kv.modwt_var_plain(x, w, 4)
    torch.testing.assert_close(v[:4].sum(0) + v[4] - x.mean(-1) ** 2,
                               x.var(-1, unbiased=False), rtol=0, atol=1e-12)


def test_validation_matches_jax():
    x = np.random.default_rng(0).standard_normal(64)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    cases = [
        lambda m, w, v: m.modwt_variance(v, w, 2, estimator="nope"),
        lambda m, w, v: m.modwt_variance(v, w, 2, boundary="nope"),
        lambda m, w, v: m.modwt_variance(v, w, 4, estimator="unbiased"),
        lambda m, w, v: m.modwt_variance(v, w, 2, method="fused",
                                         estimator="unbiased"),
        lambda m, w, v: m.modwt_variance(v, w, 2, method="fused"),  # f64
        lambda m, w, v: m.modwt_variance_ci(v, w, 2, confidence=1.5),
        lambda m, w, v: m.modwt_covariance(v, v[:32], w, 2, method="fused"),
        lambda m, w, v: m.modwt_cross_correlation(v, v, w, 2, 1,
                                                  method="fused"),
        lambda m, w, v: m.modwt_hurst(v, w, 3, min_level=3),
        lambda m, w, v: m.modwt_hurst(v, w, 3, kind="nope"),
        lambda m, w, v: m.modwt_changepoints(v, w, 2, alpha=0.2),
    ]
    for case in cases:
        with pytest.raises(ValueError) as jax_err:
            case(jw, wj, x)
        with pytest.raises(ValueError) as port_err:
            case(jt, wt, _t(x))
        assert str(port_err.value).split()[:3] == \
            str(jax_err.value).split()[:3]


# -- the variance kernel's launch plan (the CUDA kernel runs on the card
# only; its geometry is plain Python, pinned here) ---------------------------

@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Symlet 8"])
def test_var_plan_fits_every_admitted_level(name):
    from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
    m = jt.wavelet(name).length
    levels = [lv for lv in range(1, 20)
              if kc.kernel_supported(1 << 20, lv, m, "var")]
    assert levels == list(range(1, levels[-1] + 1))
    for lv in levels:
        h = kc.halo(m, lv)
        for n in (1, 16, 4095, 4096, 4097, 100003, 1 << 20):
            plan = kv.var_plan(2, n, lv, m)
            assert plan.smem <= kc.SMEM_LIMIT
            # the C entry point's shared-memory layout
            assert plan.smem == 4 * (128 + 16 * (lv + 1)
                                     + 2 * (plan.tile + h))
            assert plan.ntiles * plan.tile >= n > (plan.ntiles - 1) * plan.tile
            assert plan.grid == 2 * plan.ntiles and plan.chain == 9
    with pytest.raises(ValueError, match="unsupported shape"):
        kv.var_plan(1, 1 << 20, levels[-1] + 1, m)


def test_var_plan_edges_and_main_shape():
    from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
    # Db4 L11 the last level that fits (the gate must not narrow)
    assert kc.kernel_supported(1 << 20, 11, 8, "var")
    assert not kc.kernel_supported(1 << 20, 12, 8, "var")
    # (32, 2^20) Db4 L5: 256 tiles a row, 8192 blocks; each level takes
    # fewer than 512 chains of 9 outputs (one pass of the block's threads)
    plan = kv.var_plan(32, 1 << 20, 5, 8)
    assert plan == (4096, 256, 8192, 35400, 9)
    lo = 0
    for j in range(1, 6):
        lo += 7 << (j - 1)
        d = 1 << (j - 1)
        assert -(-(4096 + 217 - lo) // (9 * d)) * d <= 512


# -- the analytic signal and wavelet coherence ---------------------------------

@pytest.mark.parametrize("shape", [(256,), (2, 3, 101), (4, 1000)])
def test_hilbert_tools_match_jax_f64(shape):
    x = np.random.default_rng(shape[-1]).standard_normal(shape)
    want = np.asarray(jax.jit(jw.hilbert)(x))
    got = jt.hilbert(torch.from_numpy(x))
    assert got.dtype == torch.complex128 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    env = jt.envelope(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(env, np.asarray(jax.jit(jw.envelope)(x)),
                               rtol=0, atol=1e-12 * np.abs(want).max())
    f = jt.instantaneous_frequency(torch.from_numpy(x), 250.0).numpy()
    fw = np.asarray(jax.jit(lambda v: jw.instantaneous_frequency(
        v, 250.0))(x))
    assert f.shape == shape[:-1] + (shape[-1] - 1,)
    # phase increments near ±π may land on either branch in another
    # summation order: compare away from the cut
    ok = np.abs(np.abs(fw) - 125.0) > 1e-6
    assert np.abs(f - fw)[ok].max() <= 1e-9 * 125.0


def test_hilbert_gradient_dtypes_and_errors():
    rng = np.random.default_rng(3)
    x, wts = rng.standard_normal((2, 200)), rng.standard_normal((2, 200))
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(jnp.imag(jw.hilbert(v)) * wts)))(x))
    xt = torch.from_numpy(x).requires_grad_()
    (jt.hilbert(xt).imag * torch.from_numpy(wts)).sum().backward()
    assert np.abs(xt.grad.numpy() - want).max() <= 1e-9 * np.abs(want).max()
    with pytest.raises(ValueError, match="real signal"):
        jt.hilbert(torch.zeros(8, dtype=torch.complex64))
    for dtype, want_dtype in ((torch.float32, torch.complex64),
                              (torch.bfloat16, torch.complex64),
                              (torch.int32, torch.complex64)):
        assert jt.hilbert(torch.ones(16, dtype=dtype)).dtype == want_dtype
    # a pure tone's envelope is flat and its frequency the tone's
    t = np.arange(1000) / 1000.0
    tone = torch.from_numpy(np.cos(2 * np.pi * 50.0 * t))
    assert float((jt.envelope(tone)[100:-100] - 1).abs().max()) <= 1e-2
    f = jt.instantaneous_frequency(tone, 1000.0)[100:-100]
    assert float((f - 50.0).abs().max()) <= 0.5


@pytest.mark.parametrize("make", [lambda p: p.MorletWavelet(),
                                  lambda p: p.MexicanHatWavelet(),
                                  lambda p: p.DOGWavelet(1)],
                         ids=["morlet", "mexhat", "dog1"])
@pytest.mark.parametrize("octaves", [0.6, 0.0])
def test_wavelet_coherence_matches_jax_f64(make, octaves):
    """Coherence and phase within 1e-9 of the JAX package's (both smooth
    float64 scalograms with the same host operators)."""
    rng = np.random.default_rng(5)
    t = np.arange(600)
    common = np.sin(2 * np.pi * t / 30.0)
    x = common + 0.5 * rng.standard_normal((2, 600))
    y = np.roll(common, 4) + 0.5 * rng.standard_normal((2, 600))
    scales = jw.generate_log_scales(2.0, 64.0, 16)
    want = jw.wavelet_coherence(x, y, scales, make(jw),
                                smoothing_octaves=octaves)
    got = jt.wavelet_coherence(torch.from_numpy(x), torch.from_numpy(y),
                               scales, make(jt), smoothing_octaves=octaves)
    wc, gc = np.asarray(want.coherence), got.coherence.numpy()
    assert gc.shape == wc.shape == (2, 16, 600) and gc.dtype == wc.dtype
    assert np.abs(gc - wc).max() <= 1e-9
    wp, gp = np.asarray(want.phase), got.phase.numpy()
    # compare the phase where the cross-spectrum is not near ±π
    dp = np.abs(np.angle(np.exp(1j * (gp - wp))))
    assert dp.max() <= 1e-9
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    assert 0.0 <= gc.min() and gc.max() <= 1.0


def test_wavelet_coherence_dead_channel_and_float32():
    """A dead (all-zero) channel gives coherence 0, not NaN (the floored
    denominator); float32 in, float32 coherence within 1e-5 of f64."""
    x = np.random.default_rng(6).standard_normal((2, 512))
    y = x.copy()
    y[1] = 0.0
    scales = jt.generate_log_scales(2.0, 32.0, 8)
    r = jt.wavelet_coherence(torch.from_numpy(x), torch.from_numpy(y),
                             scales)
    assert bool(torch.isfinite(r.coherence).all())
    assert float(r.coherence[1].abs().max()) == 0.0
    assert float(r.coherence[0].min()) > 0.99   # a signal with itself
    r32 = jt.wavelet_coherence(torch.from_numpy(x.astype(np.float32)),
                               torch.from_numpy(np.roll(x, 3, -1).astype(
                                   np.float32)), scales)
    r64 = jt.wavelet_coherence(torch.from_numpy(x),
                               torch.from_numpy(np.roll(x, 3, -1)), scales)
    assert r32.coherence.dtype == torch.float32
    assert float((r32.coherence.double() - r64.coherence).abs().max()) \
        <= 1e-5
