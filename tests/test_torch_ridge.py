"""The port's ridge extraction against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:
ridge indices exact (the same float64 costs, the first minimum on ties on
both sides); energies 1e-12 relative (the same log-energies, a mean in
another order); frequencies exact (a gather of the given axis).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt


def _plane(rng, lead, l, n, complex_=True):
    """Two noisy ridges over a weak floor."""
    t = np.arange(n)
    rows = np.arange(l)[:, None]
    r1 = (l * 0.3 + 0.2 * l * np.sin(2 * np.pi * t / n))[None, :]
    r2 = (l * 0.75 - 0.1 * l * t / n)[None, :]
    mag = (np.exp(-0.5 * (rows - r1) ** 2) + 0.6 * np.exp(
        -0.5 * (rows - r2) ** 2))
    mag = mag + 0.05 * np.abs(rng.standard_normal(lead + (l, n)))
    if not complex_:
        return mag
    return mag * np.exp(1j * rng.uniform(0, 2 * np.pi, lead + (l, n)))


def _jax(plane, **kw):
    r = jw.extract_ridges(jnp.asarray(plane), **kw)
    return [np.asarray(a) for a in r]


CASES = [
    ((), 16, 64, dict(n_ridges=2, mask_width=2), True),
    ((2, 3), 12, 40, dict(n_ridges=1), True),
    ((2,), 20, 50, dict(n_ridges=3, mask_width=1, penalty=0.5), False),
    ((2,), 16, 30, dict(n_ridges=2, penalty=0.0), True),
    ((1,), 16, 1, dict(n_ridges=2), True),
]


@pytest.mark.parametrize("lead,l,n,kw,cplx", CASES)
def test_extract_ridges_matches_jax_f64(lead, l, n, kw, cplx):
    plane = _plane(np.random.default_rng(0), lead, l, n, cplx)
    axis = np.geomspace(1.0, 100.0, l)
    want = _jax(plane, axis_values=axis, **kw)
    got = jt.extract_ridges(torch.from_numpy(plane), axis_values=axis, **kw)
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(), want[0])
    np.testing.assert_array_equal(got.frequencies.numpy(), want[1])
    np.testing.assert_allclose(got.energy.numpy(), want[2], rtol=1e-12)
    plain = jt.extract_ridges(torch.from_numpy(plane), **kw)
    np.testing.assert_array_equal(plain.frequencies.numpy(),
                                  _jax(plane, **kw)[1])


def test_penalty_zero_is_the_columnwise_argmax():
    plane = _plane(np.random.default_rng(1), (2,), 16, 40)
    got = jt.extract_ridges(torch.from_numpy(plane), penalty=0.0)
    np.testing.assert_array_equal(got.indices.numpy()[:, 0],
                                  np.abs(plane).argmax(axis=-2))


def test_masked_bands_tie_to_the_first_bin():
    """Masked bins are −∞ log-energy, +∞ cost: equal costs that tie.  A
    plane that is zero outside a narrow band leaves, after the first
    ridge's mask, only tied (+∞ or equal) costs; both packages take the
    first minimum."""
    l, n = 12, 20
    plane = np.zeros((2, l, n))
    plane[:, 5, :] = 1.0                 # the one ridge
    plane[1, 8, ::3] = 0.5               # a few off-ridge samples
    for kw in (dict(n_ridges=3, mask_width=2), dict(n_ridges=2,
                                                    mask_width=5)):
        want = _jax(plane, eps=0.0, **kw)
        got = jt.extract_ridges(torch.from_numpy(plane), eps=0.0, **kw)
        np.testing.assert_array_equal(got.indices.numpy(), want[0])
        np.testing.assert_array_equal(got.energy.numpy(), want[2])
    # the second ridge of the first plane sees only +∞ costs: bin 0
    assert (got.indices.numpy()[0, 1] == 0).all()
    assert np.isneginf(got.energy.numpy()[0, 1])


def test_dtype_table_against_jax():
    rng = np.random.default_rng(2)
    real = _plane(rng, (2,), 10, 24, complex_=False) * 10
    cplx = _plane(rng, (2,), 10, 24)
    inputs = [real.astype(np.float32), real, (real * 10).astype(np.int32),
              cplx.astype(np.complex64), cplx]
    for a in inputs:
        want = _jax(a, n_ridges=2)
        got = jt.extract_ridges(torch.from_numpy(a), n_ridges=2)
        for g, w in zip(got, want):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), a.dtype
        np.testing.assert_array_equal(got.indices.numpy(), want[0])
    gb = jt.extract_ridges(torch.from_numpy(real).to(torch.bfloat16))
    wb = _jax(jnp.asarray(real, jnp.bfloat16))
    assert gb.energy.dtype == torch.float32 and str(wb[2].dtype) == "float32"
    np.testing.assert_array_equal(gb.indices.numpy(), wb[0])


def test_validation_errors_match_jax():
    plane = np.ones((6, 10))
    bad = [dict(n_ridges=0), dict(n_ridges=7),
           dict(n_ridges=2, mask_width=3)]
    for kw in bad:
        with pytest.raises(ValueError):
            jw.extract_ridges(jnp.asarray(plane), **kw)
        with pytest.raises(ValueError):
            jt.extract_ridges(torch.from_numpy(plane), **kw)
    with pytest.raises(ValueError):
        jw.extract_ridges(jnp.ones(10))
    with pytest.raises(ValueError):
        jt.extract_ridges(torch.ones(10))


def test_ssq_plane_ridges_match_jax():
    """The slice end to end: the ridges of a synchrosqueezed plane."""
    fs = 256.0
    t = np.arange(512) / fs
    x = np.sin(2 * np.pi * (10 * t + 20 * t * t)) + np.sin(
        2 * np.pi * 60 * t)
    fc = jt.MorletWavelet().center_frequency
    scales = jt.generate_log_scales(fc / 100.0, fc / 5.0, 24)
    want = jax.jit(lambda v: jw.extract_ridges(jw.ssq_cwt(
        v, scales, sampling_rate=fs).Tx, n_ridges=2).indices)(jnp.asarray(x))
    rt = jt.ssq_cwt(torch.from_numpy(x), scales, sampling_rate=fs)
    got = jt.extract_ridges(rt.Tx, rt.ssq_freqs, n_ridges=2)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want))
