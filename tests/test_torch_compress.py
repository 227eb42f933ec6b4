"""The port's threshold compressors (``ops/compress.py``) against the JAX
package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit``.  Tolerance 1e-12 × max|ref| at f64 (the same
comparisons against the same mean or peak; only the mean's summation order
differs), and the same zero pattern exactly.
"""
import numpy as np
import pytest
import torch

import jax

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

COMPRESSORS = ["compress_magnitude", "compress_peaks_average"]


def _coeffs(shape, seed):
    """An FWT of noise plus a few spikes: many coefficients on either side
    of the thresholds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    x[..., ::17] *= 20.0
    return x


@pytest.mark.parametrize("name", COMPRESSORS)
@pytest.mark.parametrize("shape", [(512,), (2, 3, 256), (4, 16, 16)])
@pytest.mark.parametrize("threshold", [1.0, 0.5, 2.0])
def test_compressors_match_jax_f64(name, shape, threshold):
    c = _coeffs(shape, len(shape))
    want = np.asarray(jax.jit(lambda v: getattr(jw, name)(v, threshold))(c))
    got = getattr(jt, name)(torch.from_numpy(c), threshold)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.array_equal(got.numpy() == 0.0, want == 0.0)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-12 * float(
        np.abs(want).max())
    rate = jt.compression_rate(got)
    assert rate.dtype == torch.float64
    assert abs(float(rate) - float(jw.compression_rate(want))) <= 1e-12


def test_peaks_average_keeps_the_reference_quirk():
    """peakMin is always 0 in the reference, so the magnitude is max|c|/2."""
    c = torch.tensor([0.1, -5.0, 0.2, 3.0, 2.4, -2.6], dtype=torch.float64)
    got = jt.compress_peaks_average(c)
    assert got.tolist() == [0.0, -5.0, 0.0, 3.0, 0.0, -2.6]
    assert float(jt.compression_rate(got)) == 50.0
    np.testing.assert_array_equal(
        jt.compress_magnitude(c).numpy(),
        np.asarray(jw.compress_magnitude(c.numpy())))


def test_compress_fixed_and_dtypes():
    c = _coeffs((3, 64), 9).astype(np.float32)
    got = jt.compress_fixed(torch.from_numpy(c), 1.5, 2.0)
    want = np.asarray(jw.compress_fixed(c, 1.5, 2.0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the rate is float32 unless the input is float64, as in the JAX package
    assert jt.compression_rate(got).dtype == torch.float32
    assert float(jt.compression_rate(got)) == pytest.approx(
        float(jw.compression_rate(want)), abs=1e-4)
    b = jt.compress_magnitude(torch.from_numpy(c).to(torch.bfloat16))
    assert b.dtype == torch.bfloat16
    assert jt.compression_rate(b).dtype == torch.float32
    i = jt.compress_fixed(torch.arange(-5, 6), 3)
    assert i.dtype == torch.int64
    assert i.tolist() == np.asarray(jw.compress_fixed(np.arange(-5, 6),
                                                      3)).tolist()
