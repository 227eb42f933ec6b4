"""The port's 1D and 2D scattering transforms against the JAX package's,
on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* filter banks and pair tables exact (the same float64 numpy code).
* coefficients at f64, 1e-12 relative to max|ref| per order (the same
  host constants, float64 FFTs in another order).
* ``tests/golden/regression.npz`` at the JAX package's own bound
  (``tests/test_golden.py``): ``scat_s0/s1/s2`` atol 1e-10.
* gradients at f64 against ``jax.grad``, 1e-9 relative.
* float32 input, 1e-5 relative to the f64 result.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

js1 = importlib.import_module("jwave_pro_tpu.ops.scattering")
js2 = importlib.import_module("jwave_pro_tpu.ops.scattering2d")
ts1 = importlib.import_module("jwave_pro_tpu_torch.ops.scattering")
ts2 = importlib.import_module("jwave_pro_tpu_torch.ops.scattering2d")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _check(got, want, tol):
    for g, w in zip((got.s0, got.s1, got.s2), (want.s0, want.s1, want.s2)):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape
        if w.size:
            assert _rel(g.detach().numpy(), w) <= tol


@pytest.mark.parametrize("n,j,q", [(256, 4, 2), (512, 3, 8), (300, 2, 1)])
def test_filters_and_pair_tables_equal_jax(n, j, q):
    for a, b in zip(ts1.scattering_filters(n, j, q),
                    js1.scattering_filters(n, j, q)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts1._pair_table(n, j, q), js1._pair_table(n, j, q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w,j,l", [(32, 32, 3, 4), (16, 24, 2, 3),
                                     (32, 16, 1, 2)])
def test_2d_filters_and_pair_tables_equal_jax(h, w, j, l):
    for a, b in zip(ts2.scattering2d_filters(h, w, j, l),
                    js2.scattering2d_filters(h, w, j, l)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts2._pair_table2d(j, l), js2._pair_table2d(j, l)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts2._octave_decimations(j, 1 << j, 0),
                                  js2._octave_decimations(j, 1 << j, 0))


CASES_1D = [
    ((2, 512), dict(j=4, q=4)),
    ((512,), dict(j=4, q=2, order=1)),
    ((2, 2, 256), dict(j=3, q=8, subsample=2)),
    ((2, 256), dict(j=3, q=2, oversampling=0)),
    ((2, 256), dict(j=3, q=2, oversampling=8)),
    ((2, 64), dict(j=1, q=1)),
]


@pytest.mark.parametrize("shape,kw", CASES_1D)
def test_scattering1d_matches_jax_f64(shape, kw):
    x = np.random.default_rng(0).standard_normal(shape)
    want = js1.scattering1d(jnp.asarray(x), **kw)
    got = jt.scattering1d(torch.from_numpy(x), **kw)
    _check(got, want, 1e-12)
    np.testing.assert_array_equal(got.xi1, want.xi1)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    assert _rel(got.stack().numpy(), want.stack()) <= 1e-12


CASES_2D = [
    ((2, 32, 32), dict(j=3, l=4)),
    ((32, 32), dict(j=2, l=3, order=1)),
    ((2, 16, 24), dict(j=2, l=2, subsample=2)),
    ((2, 32, 32), dict(j=2, l=4, oversampling=6)),
    ((1, 2, 16, 16), dict(j=1, l=2)),
]


@pytest.mark.parametrize("shape,kw", CASES_2D)
def test_scattering2d_matches_jax_f64(shape, kw):
    x = np.random.default_rng(1).standard_normal(shape)
    want = js2.scattering2d(jnp.asarray(x), **kw)
    got = jt.scattering2d(torch.from_numpy(x), **kw)
    _check(got, want, 1e-12)
    np.testing.assert_array_equal(got.meta1, want.meta1)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    assert _rel(got.stack().numpy(), want.stack()) <= 1e-12


def test_golden_regression_pins():
    import pathlib
    g = np.load(pathlib.Path(__file__).parent / "golden" / "regression.npz")
    sc = jt.scattering1d(torch.from_numpy(g["input_512"].astype(np.float64)),
                         j=4, q=2)
    np.testing.assert_allclose(sc.s0.numpy(), g["scat_s0"], atol=1e-10)
    np.testing.assert_allclose(sc.s1.numpy(), g["scat_s1"], atol=1e-10)
    np.testing.assert_allclose(sc.s2.numpy(), g["scat_s2"], atol=1e-10)


def _grad_pair(jfn, tfn, x, rng):
    out = jfn(jnp.asarray(x))
    gs = [rng.standard_normal(np.shape(o)) for o in out]

    def jloss(v):
        return sum(jnp.sum(o * g) for o, g in zip(jfn(v), gs))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    sum((o * torch.from_numpy(g)).sum()
        for o, g in zip(tfn(xt), gs)).backward()
    return xt.grad.numpy(), want


def test_scattering1d_gradient_matches_jax_grad():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 256))
    got, want = _grad_pair(
        lambda v: js1.scattering1d(v, j=3, q=2)[:3],
        lambda v: jt.scattering1d(v, j=3, q=2)[:3], x, rng)
    assert _rel(got, want) <= 1e-9


def test_scattering2d_gradient_matches_jax_grad():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16))
    got, want = _grad_pair(
        lambda v: js2.scattering2d(v, j=2, l=3)[:3],
        lambda v: jt.scattering2d(v, j=2, l=3)[:3], x, rng)
    assert _rel(got, want) <= 1e-9


def test_dtype_tables_against_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 128)) * 10
    img = rng.standard_normal((2, 16, 16)) * 10
    w64_1 = js1.scattering1d(jnp.asarray(x), j=3, q=2)
    w64_2 = js2.scattering2d(jnp.asarray(img), j=2, l=2)
    for dt in (np.float32, np.float64, np.int32):
        for a, jfn, tfn, ref in (
                (x, lambda v: js1.scattering1d(v, j=3, q=2),
                 lambda v: jt.scattering1d(v, j=3, q=2), w64_1),
                (img, lambda v: js2.scattering2d(v, j=2, l=2),
                 lambda v: jt.scattering2d(v, j=2, l=2), w64_2)):
            an = a.astype(dt)
            want, got = jfn(jnp.asarray(an)), tfn(torch.from_numpy(an))
            for g, w in zip(got[:3], want[:3]):
                assert str(g.dtype).split(".")[-1] == str(w.dtype), dt
            if dt == np.float32:
                _check(got, ref, 1e-5)
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = jt.scattering1d(xb, j=3, q=2)
    want = js1.scattering1d(jnp.asarray(x, jnp.bfloat16), j=3, q=2)
    assert got.s1.dtype == torch.float32 and str(want.s1.dtype) == "float32"
    _check(got, want, 1e-5)


def test_validation_errors_match_jax():
    x = np.zeros((2, 96))
    img = np.zeros((2, 24, 24))
    bad = [
        (lambda p, v, m: p.scattering1d(v + 1j, 2), "1"),
        (lambda p, v, m: p.scattering1d(v, 6), "1"),
        (lambda p, v, m: p.scattering1d(v, 2, order=3), "1"),
        (lambda p, v, m: p.scattering1d(v, 0), "1"),
        (lambda p, v, m: p.scattering1d(v, 2, q=0), "1"),
        (lambda p, v, m: p.scattering2d(m + 1j, 2), "2"),
        (lambda p, v, m: p.scattering2d(m, 4), "2"),
        (lambda p, v, m: p.scattering2d(m[0, 0], 1), "2"),
        (lambda p, v, m: p.scattering2d(m, 1, order=0), "2"),
        (lambda p, v, m: p.scattering2d(m, 1, l=0), "2"),
    ]
    for fn, _ in bad:
        with pytest.raises(ValueError):
            fn(jw, jnp.asarray(x), jnp.asarray(img))
        with pytest.raises(ValueError):
            fn(jt, torch.from_numpy(x), torch.from_numpy(img))
