"""The port's 1D denoise against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 thresholds and the 'auto' pipeline, 1e-12 absolute: the same float64
  arithmetic in both; hard thresholding is discontinuous, but the inputs
  are random, so no coefficient sits within rounding of a threshold.
* ``method='fused'``, f32, 2e-5 absolute: the port's plain version of the
  fused kernel against the JAX Pallas kernel in interpret mode, the bound
  ``tests/test_pallas_kernels.py`` holds the Pallas kernel to.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.denoise_pallas import (
    modwt_denoise_fused as jax_denoise_fused,
)
from jwave_pro_tpu_torch.kernels import denoise_cuda as kd

DB4 = "Daubechies 4"


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_denoise(*static):
    return jax.jit(lambda x: jw.modwt_denoise(x, *static))


def _denoise_both(x, level, mode, method, threshold):
    want = np.asarray(_jax_denoise(jw.wavelet(DB4), level, mode, method,
                                   threshold)(x))
    got = jt.modwt_denoise(_t(x), jt.wavelet(DB4), level, mode=mode,
                           method=method, threshold=threshold)
    return got, want


def test_soft_hard_threshold_match_jax():
    c = np.random.default_rng(0).standard_normal((3, 50))
    t = np.array([[0.2], [0.5], [1.0]])
    np.testing.assert_array_equal(jt.soft_threshold(_t(c), _t(t)).numpy(),
                                  np.asarray(jw.soft_threshold(c, t)))
    np.testing.assert_array_equal(jt.hard_threshold(_t(c), 0.5).numpy(),
                                  np.asarray(jw.hard_threshold(c, 0.5)))


@pytest.mark.parametrize("n", [1000, 1001])
def test_mad_sigma_median_is_midpoint_like_jnp(n):
    """An even count takes the mean of the two middle values (jnp.median),
    not torch.median's lower middle value."""
    d = np.random.default_rng(n).standard_normal((2, n))
    got = jt.mad_sigma(_t(d)).numpy()
    np.testing.assert_allclose(got, np.asarray(jw.mad_sigma(d)), rtol=0,
                               atol=1e-15)
    lower = torch.median(torch.abs(_t(d)), dim=-1).values.numpy() / 0.6745
    assert (not np.allclose(got, lower)) if n % 2 == 0 else \
        np.allclose(got, lower)


def test_universal_threshold_matches_jax():
    d = np.random.default_rng(1).standard_normal((4, 512))
    np.testing.assert_allclose(
        jt.universal_threshold(_t(d)).numpy(),
        np.asarray(jw.universal_threshold(d)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["dense", "sparse", "batched"])
def test_sure_threshold_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "dense":     # energy above the sparsity bound: SURE branch
        y, sigma = rng.normal(size=512) + rng.normal(scale=3.0, size=512), 1.0
    elif case == "sparse":  # pure noise: universal fallback
        y, sigma = rng.normal(size=1024), 1.3
    else:
        y = rng.normal(size=(3, 256)) * np.array([[1.0], [2.0], [5.0]])
        sigma = None
    got = jt.sure_threshold(_t(y), sigma=sigma).numpy()
    want = np.asarray(jw.sure_threshold(y, sigma=sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("signal_scale", [2.0, 0.5])
def test_bayes_threshold_matches_jax(signal_scale):
    rng = np.random.default_rng(4)
    d = rng.normal(scale=1.0, size=(2, 4096)) \
        + rng.normal(scale=signal_scale, size=(2, 4096))
    sigma = 1.3
    np.testing.assert_allclose(jt.bayes_threshold(_t(d), sigma).numpy(),
                               np.asarray(jw.bayes_threshold(d, sigma)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("rule", [None, "universal", "sure", "bayes", 0.7])
def test_modwt_denoise_auto_matches_jax_f64(rule, mode):
    x = np.random.default_rng(6).standard_normal((2, 1000))   # even N
    got, want = _denoise_both(x, 4, mode, "auto", rule)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rule,mode", [
    (None, "soft"), ("sure", "soft"), ("bayes", "soft"), (None, "hard"),
    (0.8, "soft"),
])
def test_modwt_denoise_fused_matches_jax(rule, mode):
    x = np.random.default_rng(8).standard_normal((2, 4096)).astype(
        np.float32)
    got, want = _denoise_both(x, 3, mode, "fused", rule)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_fused_plain_matches_jax_kernel_per_row_arbitrary_n():
    """Per-row thresholds at an arbitrary N, straight to both kernels."""
    x = np.random.default_rng(9).standard_normal((8, 2000)).astype(
        np.float32)
    thr = np.linspace(0.1, 2.0, 8).astype(np.float32)
    want = np.asarray(jax_denoise_fused(jnp.asarray(x), jnp.asarray(thr),
                                        jw.wavelet(DB4), 3, interpret=True))
    got = kd.modwt_denoise_fused(_t(x), _t(thr), jt.wavelet(DB4), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_fused_1d_input():
    x = np.random.default_rng(10).standard_normal(4096).astype(np.float32)
    got = jt.modwt_denoise(_t(x), jt.wavelet(DB4), 3, method="fused",
                           threshold=0.8)
    want = jt.modwt_denoise(_t(x)[None], jt.wavelet(DB4), 3, method="fused",
                            threshold=0.8)[0]
    assert got.shape == (4096,)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_plain_bf16_rounds_once():
    """bf16 in and out, the whole chain in f32: equals the f32 result
    rounded to bf16 once."""
    x = _t(np.random.default_rng(12).standard_normal((4, 1024)).astype(
        np.float32)).bfloat16()
    thr = torch.full((4,), 0.8)
    w = jt.wavelet(DB4)
    got = kd.modwt_denoise_plain(x, thr, w, 3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kd.modwt_denoise_plain(x.float(), thr, w,
                                                   3).bfloat16())


def test_fused_raises_on_unsupported_shape():
    # Db4 L9: the two-sided window's (L+2) rows exceed a block's 227 KB
    with pytest.raises(ValueError, match="unsupported shape"):
        jt.modwt_denoise(torch.zeros(2, 4096), jt.wavelet(DB4), 9,
                         method="fused", threshold=0.5)
    with pytest.raises(ValueError):
        jt.modwt_denoise(torch.zeros(2, 2, 64), jt.wavelet(DB4), 2,
                         method="fused")


def test_unknown_rule_raises_like_jax():
    x = np.ones(256)
    for method in ("auto", "fused"):
        with pytest.raises(ValueError, match="unknown threshold rule"):
            jt.modwt_denoise(_t(x), jt.wavelet(DB4), 3, method=method,
                             threshold="nope")
    with pytest.raises(ValueError, match="unknown threshold rule"):
        jw.modwt_denoise(x, jw.wavelet(DB4), 3, threshold="nope")


def test_modwt_denoise_inplace_writes_into_x():
    x = _t(np.random.default_rng(13).standard_normal((2, 1024)))
    want = jt.modwt_denoise(x, jt.wavelet(DB4), 4)
    ptr = x.data_ptr()
    out = jt.modwt_denoise_inplace(x, jt.wavelet(DB4), 4)
    assert out.data_ptr() == ptr and out is x
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(TypeError):
        jt.modwt_denoise_inplace(torch.zeros(64, dtype=torch.int32),
                                 jt.wavelet(DB4), 2)


def test_denoise_reduces_mse():
    """The reference demo's claim (MODWTExample.java:125-172) holds."""
    rng = np.random.default_rng(6)
    t = np.linspace(0, 1, 2048)
    clean = np.sign(np.sin(2 * np.pi * 4 * t))
    noisy = clean + 0.35 * rng.normal(size=2048)
    for rule in ("universal", "sure", "bayes"):
        out = jt.modwt_denoise(_t(noisy), jt.wavelet(DB4), 4,
                               threshold=rule).numpy()
        assert np.mean((out - clean) ** 2) < 0.5 * np.mean(
            (noisy - clean) ** 2), rule
