"""The port's empirical wavelet transform against the JAX package's, on the
CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:
detected peaks and boundaries exact (the same float64 magnitudes, the same
K local maxima with ties to the lower bin); filters, components and the
inverse 1e-12 relative to max|ref| (the same float64 formulas, FFTs in
another order); gradients with respect to the signal 1e-9 relative
against ``jax.grad``.  The JAX package's gradient with respect to the
boundaries is NaN (``sqrt`` at 0 under ``clip``'s tie rule); the port's
is held to a central difference of its own bank, 1e-6 relative.  A
float32 bank: the port's within one float32 rounding (6e-8) of its
float64 bank on the same boundaries; the JAX package's float32 bank
differs by more than 1e-5 (its float32 sqrt(1 − rise²)).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _tones(rng, shape, freqs=(0.05, 0.18, 0.33)):
    t = np.arange(shape[-1])
    x = sum((k + 1) * np.cos(2 * np.pi * f * t) for k, f in enumerate(freqs))
    return x + 0.3 * rng.standard_normal(shape)


def _jax(x, k, b=None):
    return [np.asarray(a) for a in jw.ewt1d(jnp.asarray(x), k, b)]


@pytest.mark.parametrize("shape,k", [((2, 256), 3), ((300,), 4),
                                     ((2, 2, 128), 2), ((2, 255), 5)])
def test_ewt1d_detected_matches_jax_f64(shape, k):
    x = _tones(np.random.default_rng(0), shape)
    want = _jax(x, k)
    got = jt.ewt1d(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.peaks.numpy(), want[3])
    np.testing.assert_array_equal(got.boundaries.numpy(), want[2])
    assert _rel(got.filters.numpy(), want[1]) <= 1e-12
    assert _rel(got.components.numpy(), want[0]) <= 1e-12
    back = got.reconstruct()
    assert _rel(back.numpy(), np.asarray(jw.iewt1d(
        jnp.asarray(want[0]), jnp.asarray(want[1])))) <= 1e-12
    assert _rel(back.numpy(), x) <= 1e-12          # the tight frame


def test_ewt1d_explicit_boundaries_match_jax_f64():
    x = _tones(np.random.default_rng(1), (2, 256))
    for b in ([0.6, 1.5], np.array([[0.4, 1.0], [0.9, 2.2]])):
        want = _jax(x, 3, b)
        got = jt.ewt1d(torch.from_numpy(x), 3, b)
        np.testing.assert_array_equal(got.boundaries.numpy(), want[2])
        np.testing.assert_array_equal(got.peaks.numpy(), want[3])
        assert _rel(got.filters.numpy(), want[1]) <= 1e-12
        assert _rel(got.components.numpy(), want[0]) <= 1e-12


@pytest.mark.parametrize("gamma", [None, 0.05, [0.02, 0.1]])
def test_filter_bank_matches_jax(gamma):
    b = np.array([[0.3, 0.9, 2.0], [0.5, 1.1, 2.6]])
    gj = None if gamma is None else jnp.asarray(gamma)
    want = np.asarray(jw.ewt_filter_bank(jnp.asarray(b), 100, gj))
    got = jt.ewt_filter_bank(torch.from_numpy(b), 100, gamma)
    assert _rel(got.numpy(), want) <= 1e-12
    if gamma is None:   # the tight frame: Σ_k f_k² = 1
        np.testing.assert_allclose((got ** 2).sum(dim=-2).numpy(), 1.0,
                                   atol=1e-12)


def test_float32_bank_is_computed_in_float64():
    """The port computes the bank in float64 and rounds it once; the JAX
    package's float32 bank loses up to ~2e-4 where sqrt(1 − rise²) meets
    rise ≈ 1.  Both return float32."""
    b = np.array([[0.3, 0.9, 2.0], [0.5, 1.1, 2.6]])
    ref = jt.ewt_filter_bank(torch.from_numpy(b), 4096).numpy()
    got = jt.ewt_filter_bank(torch.from_numpy(b.astype(np.float32)), 4096)
    want = np.asarray(jw.ewt_filter_bank(jnp.asarray(b, jnp.float32), 4096))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    b32 = b.astype(np.float32).astype(np.float64)
    ref32 = jt.ewt_filter_bank(torch.from_numpy(b32), 4096).numpy()
    assert np.abs(got.numpy() - ref32).max() <= 6e-8     # one rounding
    assert np.abs(want - ref32).max() > 1e-5
    assert np.abs(ref - ref32).max() < 1.0


def test_fewer_local_maxima_than_modes_ties_to_the_lower_bins():
    """Spectra with one and two smooth peaks: the other picks are −∞
    ties; ``lax.top_k`` takes the lowest bins, and so does the port's
    stable sort."""
    n = 64
    k = np.arange(n // 2 + 1)
    mags = [np.exp(-(k - 9.0) ** 2 / 200.0),
            np.exp(-(k - 9.0) ** 2 / 8.0) + np.exp(-(k - 20.0) ** 2 / 8.0)]
    x = np.stack([np.fft.irfft(m, n) for m in mags])
    for modes in (3, 4):
        want = _jax(x, modes)
        got = jt.ewt1d(torch.from_numpy(x), modes)
        np.testing.assert_array_equal(got.peaks.numpy(), want[3])
        np.testing.assert_array_equal(got.boundaries.numpy(), want[2])
        assert _rel(got.components.numpy(), want[0]) <= 1e-12
    bins = np.round(got.peaks.numpy() * n / (2 * np.pi)).astype(int)
    assert bins.tolist() == [[1, 2, 3, 9], [1, 2, 9, 20]]


@pytest.mark.parametrize("explicit", [False, True])
def test_ewt1d_gradient_matches_jax_grad(explicit):
    rng = np.random.default_rng(2)
    x = _tones(rng, (2, 128))
    b = [0.5, 1.4] if explicit else None
    g0 = rng.standard_normal((2, 3, 128))
    g1 = rng.standard_normal((2, 3, 65))

    def jloss(v):
        r = jw.ewt1d(v, 3, b)
        return jnp.sum(r.components * g0) + jnp.sum(r.filters * g1)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    r = jt.ewt1d(xt, 3, b)
    ((r.components * torch.from_numpy(g0)).sum()
     + (r.filters * torch.from_numpy(g1)).sum()).backward()
    assert _rel(xt.grad.numpy(), want) <= 1e-9


def test_filter_bank_gradient_in_the_boundaries():
    b = np.array([0.5, 1.2, 2.0])
    wts = torch.linspace(-1.0, 1.0, 4 * 33, dtype=torch.float64).reshape(4,
                                                                        33)
    bt = torch.from_numpy(b).requires_grad_()
    (jt.ewt_filter_bank(bt, 64) * wts).sum().backward()
    h = 1e-6
    fd = []
    for i in range(3):
        e = np.zeros(3)
        e[i] = h
        hi = (jt.ewt_filter_bank(torch.from_numpy(b + e), 64) * wts).sum()
        lo = (jt.ewt_filter_bank(torch.from_numpy(b - e), 64) * wts).sum()
        fd.append(float(hi - lo) / (2 * h))
    assert _rel(bt.grad.numpy(), fd) <= 1e-6
    jg = jax.grad(lambda v: jnp.sum(jw.ewt_filter_bank(v, 64)
                                    * jnp.asarray(wts.numpy())))(
        jnp.asarray(b))
    assert np.isnan(np.asarray(jg)).all()


def test_dtype_table_against_jax():
    rng = np.random.default_rng(3)
    x = _tones(rng, (2, 128)) * 10
    for dt in (np.float32, np.float64, np.int32):
        xn = x.astype(dt)
        for b in (None, [0.5, 1.4]):
            want = jw.ewt1d(jnp.asarray(xn), 3, b)
            got = jt.ewt1d(torch.from_numpy(xn), 3, b)
            for g, w in zip(got, want):
                assert str(g.dtype).split(".")[-1] == str(w.dtype), (dt, b)
            np.testing.assert_array_equal(got.boundaries.numpy(),
                                          np.asarray(want.boundaries))
            back = jt.iewt1d(got.components, got.filters)
            assert str(back.dtype).split(".")[-1] == str(jw.iewt1d(
                want.components, want.filters).dtype)
    # bfloat16: the JAX package raises (its rfft takes f32/f64 only); the
    # port transforms in float32
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    with pytest.raises(ValueError):
        jw.ewt1d(jnp.asarray(x, jnp.bfloat16), 3)
    got = jt.ewt1d(xb, 3)
    want = jw.ewt1d(jnp.asarray(xb.float().numpy()), 3)
    assert got.components.dtype == torch.float32
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_precision_input_is_wider_than_jax(dtype):
    """Float16 and bfloat16 input: the JAX package raises ``ValueError``
    (its rfft takes float32 or float64 only); the port transforms in
    float32.  Against the JAX package's float64 transform of the same
    rounded input: the peaks in the same bins (well separated tones), the
    boundaries within one float32 rounding, the components within 1e-5
    relative (float32 FFTs) and the inverse within 1e-5 relative of that
    input."""
    x = _tones(np.random.default_rng(7), (2, 256)) * 10
    half = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    with pytest.raises(ValueError, match="float32 or float64"):
        jw.ewt1d(jnp.asarray(x, jnp.dtype(dtype)), 3)
    want = _jax(half.double().numpy(), 3)
    got = jt.ewt1d(half, 3)
    assert got.components.dtype == torch.float32
    bins = 256 / (2 * np.pi)
    np.testing.assert_array_equal(np.rint(got.peaks.numpy() * bins),
                                  np.rint(want[3] * bins))
    np.testing.assert_allclose(got.boundaries.numpy(), want[2],
                               rtol=2.0 ** -23)
    assert _rel(got.components.numpy(), want[0]) <= 1e-5
    back = jt.iewt1d(got.components, got.filters)
    assert _rel(back.numpy(), half.double().numpy()) <= 1e-5


def test_validation_errors_match_jax():
    x = np.zeros((2, 64))
    bad = [lambda p, v: p.ewt1d(v + 1j, 3), lambda p, v: p.ewt1d(v, 1),
           lambda p, v: p.ewt1d(v, 17), lambda p, v: p.ewt1d(v, 3, [0.5]),
           lambda p, v: p.ewt_filter_bank(v[:, :0], 64)]
    for fn in bad:
        with pytest.raises(ValueError):
            fn(jw, jnp.asarray(x))
        with pytest.raises(ValueError):
            fn(jt, torch.from_numpy(x))
