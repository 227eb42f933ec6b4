"""The port's 2D continuous wavelets and 2D CWT against the JAX package's,
on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* ψ and ψ̂ at f64, 1e-12 absolute: the same closed forms in float64.
* ``cwt2`` and ``icwt2`` at f64, 1e-12 relative to max|ref|: both build
  the multiplier stack on the host in float64 and run float64 FFTs
  (pocketfft on both sides, the sums in another order).
* float32 input, 1e-5 relative to the f64 result (f32 FFTs).
* gradients of ``cwt2`` at f64 against ``jax.grad``, 1e-9 relative.
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

tcwt2 = importlib.import_module("jwave_pro_tpu_torch.ops.cwt2d")

PAIRS = [
    (lambda p: p.MexicanHat2D(), "Mexican Hat 2D"),
    (lambda p: p.MexicanHat2D(1.7), "Mexican Hat 2D σ=1.7"),
    (lambda p: p.Morlet2D(), "Morlet 2D"),
    (lambda p: p.Morlet2D(6.5), "Morlet 2D k0=6.5"),
]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _img(rng, *shape):
    return rng.standard_normal(shape)


@pytest.mark.parametrize("make,label", PAIRS)
def test_psi_and_psi_hat_match_jax_f64(make, label):
    wj, wt = make(jw), make(jt)
    x = np.linspace(-6.0, 6.0, 37)[:, None] * np.ones((1, 29))
    y = np.linspace(-5.0, 5.0, 29)[None, :] * np.ones((37, 1))
    for fj, ft in ((wj.psi, wt.psi), (wj.psi_hat, wt.psi_hat)):
        got = ft(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(fj(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got = wt.psi_scaled(torch.from_numpy(x), torch.from_numpy(y), 2.5,
                        0.7).numpy()
    want = np.asarray(wj.psi_scaled(jnp.asarray(x), jnp.asarray(y), 2.5,
                                    0.7))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got = wt.psi_hat_scaled(x, y, 0.6, 1.1).numpy()      # host numbers
    want = np.asarray(wj.psi_hat_scaled(jnp.asarray(x), jnp.asarray(y),
                                        0.6, 1.1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.dtype == np.complex128
    assert (wt.name, wt.directional, wt.real_even_hat) == (
        wj.name, wj.directional, wj.real_even_hat)


@pytest.mark.parametrize("make,label", PAIRS)
def test_from_jax_continuous_takes_the_2d_families(make, label):
    assert jt.from_jax_continuous(make(jw)) == make(jt)
    assert hash(make(jt)) == hash(make(jt))


def test_factory_and_validation_errors_match_jax():
    for name in ("mexican hat 2d", "LoG", "Ricker 2D", "morlet 2d",
                 "Morlet"):
        assert type(jt.continuous_wavelet2d(name)).__name__ == type(
            jw.continuous_wavelet2d(name)).__name__
    for pkg in (jw, jt):
        with pytest.raises(ValueError, match="unknown 2D"):
            pkg.continuous_wavelet2d("paul")
        with pytest.raises(ValueError, match="sigma"):
            pkg.MexicanHat2D(0.0)
        with pytest.raises(ValueError, match="k0"):
            pkg.Morlet2D(-1.0)
    img = np.zeros((8, 8))
    for fn in (lambda p, a: p.cwt2(a[0], [1.0]),
               lambda p, a: p.cwt2(a, [1.0, -1.0])):
        with pytest.raises(ValueError):
            fn(jw, jnp.asarray(img))
        with pytest.raises(ValueError):
            fn(jt, torch.from_numpy(img))


CASES = [
    # (shape, wavelet, scales, angles, fs)
    ((2, 24, 40), "mh", (1.0, 2.0, 3.5, 6.0), None, 1.0),
    ((24, 40), "mh", (0.8, 2.5), None, 2.0),
    ((2, 3, 16, 20), "mh", (1.5,), None, 1.0),
    ((2, 24, 40), "mo", (1.0, 2.0, 4.0), (0.0, math.pi / 4, math.pi / 2),
     1.0),
    ((24, 32), "mo", (2.0, 3.0), None, 1.0),
    ((2, 24, 40), "mh", (1.0, 2.0), (0.0, 1.0), 1.0),
]


def _wav(pkg, kind):
    return pkg.MexicanHat2D() if kind == "mh" else pkg.Morlet2D()


@pytest.mark.parametrize("shape,kind,scales,angles,fs", CASES)
def test_cwt2_matches_jax_f64(shape, kind, scales, angles, fs):
    x = _img(np.random.default_rng(1), *shape)
    want = jw.cwt2(jnp.asarray(x), scales, _wav(jw, kind), angles, fs)
    got = jt.cwt2(torch.from_numpy(x), scales, _wav(jt, kind), angles, fs)
    assert got.coefficients.shape == want.coefficients.shape
    assert got.coefficients.dtype == (torch.float64 if kind == "mh"
                                      else torch.complex128)
    assert _rel(got.coefficients.numpy(), want.coefficients) <= 1e-12
    np.testing.assert_array_equal(got.scales.numpy(), want.scales)
    if angles is None:
        assert got.angles is None and want.angles is None
    else:
        np.testing.assert_array_equal(got.angles.numpy(), want.angles)
    assert (got.sampling_rate, got.wavelet_name) == (want.sampling_rate,
                                                     want.wavelet_name)
    for prop in ("magnitude", "phase", "scalogram"):
        g = getattr(got, prop).numpy()
        w = np.asarray(getattr(want, prop))
        assert np.abs(g - w).max() <= 1e-12 * max(np.abs(w).max(), 1.0)


def test_cwt2_complex_input_matches_jax():
    rng = np.random.default_rng(2)
    x = _img(rng, 2, 16, 24) + 1j * _img(rng, 2, 16, 24)
    for kind in ("mh", "mo"):
        want = jw.cwt2(jnp.asarray(x), (1.0, 3.0), _wav(jw, kind))
        got = jt.cwt2(torch.from_numpy(x), (1.0, 3.0), _wav(jt, kind))
        assert got.coefficients.dtype == torch.complex128
        assert _rel(got.coefficients.numpy(), want.coefficients) <= 1e-12


def test_plane_chunking_rule_and_a_chunked_call_match_jax():
    # the JAX package's rule (cwt2d.py:160-166), restated
    assert tcwt2._plane_chunk(16, 512, 512, 8) == 1
    assert tcwt2._plane_chunk(4, 512, 512, 48) == 4
    assert tcwt2._plane_chunk(1, 64, 64, 8) == 8
    assert tcwt2._plane_chunk(4, 256, 256, 40) == 10
    # (4, 256, 256) at 40 scales: 10.5M elements → four chunks of 10 planes
    x = _img(np.random.default_rng(3), 4, 256, 256)
    scales = tuple(np.exp(np.linspace(0.0, math.log(12.0), 40)))
    want = jax.jit(lambda v: jw.cwt2(v, scales).coefficients)(
        jnp.asarray(x))
    got = jt.cwt2(torch.from_numpy(x), scales).coefficients
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("kind,angles", [("mh", None),
                                         ("mo", (0.0, 0.8, 1.6, 2.4))])
def test_icwt2_matches_jax_f64(kind, angles):
    x = _img(np.random.default_rng(4), 2, 32, 32)
    scales = tuple(np.exp(np.linspace(0.0, math.log(8.0), 6)))
    rj = jw.cwt2(jnp.asarray(x), scales, _wav(jw, kind), angles)
    rt = jt.cwt2(torch.from_numpy(x), scales, _wav(jt, kind), angles)
    want = jw.icwt2(rj, _wav(jw, kind))
    got = jt.icwt2(rt, _wav(jt, kind))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-12
    # explicit grids give the same answer
    got2 = jt.icwt2(rt, _wav(jt, kind), scales=scales, angles=angles)
    assert _rel(got2.numpy(), want) <= 1e-12


def test_dtype_table_against_jax():
    rng = np.random.default_rng(5)
    x = _img(rng, 2, 16, 16) * 10
    cases = {"float32": np.float32, "float64": np.float64,
             "int32": np.int32}
    for name, dt in cases.items():
        xn = x.astype(dt)
        for kind, angles in (("mh", None), ("mo", (0.0, 1.0))):
            want = jw.cwt2(jnp.asarray(xn), (1.0, 2.0), _wav(jw, kind),
                           angles)
            got = jt.cwt2(torch.from_numpy(xn), (1.0, 2.0), _wav(jt, kind),
                          angles)
            assert str(got.coefficients.dtype).split(".")[-1] == str(
                want.coefficients.dtype), (name, kind)
            assert str(got.scales.dtype).split(".")[-1] == str(
                want.scales.dtype)
            back = jt.icwt2(got, _wav(jt, kind))
            assert str(back.dtype).split(".")[-1] == str(
                jw.icwt2(want, _wav(jw, kind)).dtype)
            tol = 1e-12 if dt == np.float64 else 1e-5
            want64 = jw.cwt2(jnp.asarray(xn.astype(np.float64)), (1.0, 2.0),
                             _wav(jw, kind), angles).coefficients
            assert _rel(got.coefficients.numpy(), want64) <= tol
    # bfloat16: the port computes in float32 on both paths; the JAX
    # package does so on its complex path and raises on its real one
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = jt.cwt2(xb, (1.0, 2.0)).coefficients
    assert got.dtype == torch.float32
    with pytest.raises(ValueError):
        jw.cwt2(jnp.asarray(x, jnp.bfloat16), (1.0, 2.0))
    want = jw.cwt2(jnp.asarray(x, jnp.bfloat16), (1.0, 2.0), jw.Morlet2D())
    got = jt.cwt2(xb, (1.0, 2.0), jt.Morlet2D()).coefficients
    assert got.dtype == torch.complex64 and str(
        want.coefficients.dtype) == "complex64"
    assert _rel(got.numpy(), want.coefficients) <= 1e-5


@pytest.mark.parametrize("kind,angles", [("mh", None), ("mo", (0.0, 1.2))])
def test_cwt2_gradient_matches_jax_grad(kind, angles):
    rng = np.random.default_rng(6)
    x = _img(rng, 2, 16, 24)
    scales = (1.0, 2.5)
    shape = (2, 2) + ((2,) if angles else ()) + (16, 24)
    g1, g2 = rng.standard_normal(shape), rng.standard_normal(shape)

    def jloss(v):
        c = jw.cwt2(v, scales, _wav(jw, kind), angles).coefficients
        return jnp.sum(jnp.real(c) * g1 + jnp.imag(c) * g2)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    c = jt.cwt2(xt, scales, _wav(jt, kind), angles).coefficients
    re, im = (c.real, c.imag) if c.is_complex() else (c, torch.zeros_like(c))
    (re * torch.from_numpy(g1) + im * torch.from_numpy(g2)).sum().backward()
    assert _rel(xt.grad.numpy(), want) <= 1e-9
