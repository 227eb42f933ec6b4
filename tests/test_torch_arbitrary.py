"""The port's arbitrary-length wrappers (``ops/arbitrary.py``: the Ancient
Egyptian Decomposition and the Shifting WT) against the JAX package's, on
the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit`` with the wavelet static.  Tolerance 1e-12 ×
max|ref| at f64: both run the same decimated steps per block in float64.
``TestSWTQuirk`` mirrors the JAX package's contract
(``tests/test_fft_facade.py``): power-of-two and 2^k + 1 lengths round-trip
exactly; even lengths that are not powers of two do not (O(1) wrong, as in
the reference); ``strict=True`` raises ``NotValid`` at 42, 6 and 43.  At
the odd widths the reverse reaches (43 → 42 → 21), both packages fold
the odd step the same way and agree.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

jarb = importlib.import_module("jwave_pro_tpu.ops.arbitrary")


@functools.lru_cache(maxsize=None)
def _jax(fn, name, *static):
    w = jw.wavelet(name)
    return jax.jit(lambda x: getattr(jarb, fn)(x, w, *static))


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", ["Daubechies 4", "Haar", "Symlet 8"])
@pytest.mark.parametrize("shape", [(42,), (2, 3, 1000), (2, 100003)])
def test_aed_matches_jax_f64(name, shape):
    x = np.random.default_rng(shape[-1]).standard_normal(shape)
    want = np.array(_jax("aed_forward", name)(x))
    got = jt.aed_forward(torch.from_numpy(x), jt.wavelet(name))
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-12
    back = jt.aed_inverse(torch.from_numpy(want), jt.wavelet(name))
    assert _rel(back, _jax("aed_inverse", name)(want)) <= 1e-12
    assert _rel(back, x) <= 1e-10


def test_aed_level_and_transform_arguments():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 600)))
    w = jt.wavelet("Daubechies 4")
    got = jt.aed_forward(x, w, level=2)
    want = np.asarray(jw.aed_forward(x.numpy(), jw.wavelet("Daubechies 4"),
                                     level=2))
    assert _rel(got, want) <= 1e-12
    y = jt.aed_forward(x, w, transform=lambda b, _w, lv: jt.cdf97(b, lv))
    assert _rel(jt.aed_inverse(y, w, transform=lambda b, _w, lv:
                               jt.icdf97(b, lv)), x.numpy()) <= 1e-10


@pytest.mark.parametrize("name", ["Haar", "Daubechies 4"])
@pytest.mark.parametrize("n", [32, 33, 42, 43, 6, 9, 1, 2, 100003])
def test_swt_matches_jax_f64(name, n):
    x = np.random.default_rng(n).standard_normal((2, n))
    want = np.array(_jax("swt_forward", name)(x))
    got = jt.swt_forward(torch.from_numpy(x), jt.wavelet(name))
    assert _rel(got, want) <= 1e-12
    if n % 2:
        assert got[..., -1].tolist() == x[..., -1].tolist()
    back_want = np.asarray(_jax("swt_inverse", name)(want))
    assert _rel(jt.swt_inverse(torch.from_numpy(want), jt.wavelet(name)),
                back_want) <= 1e-12


class TestSWTQuirk:
    """The port keeps the reference-faithful SWT invertibility contract."""

    def test_pow2_and_pow2_plus_one_roundtrip(self):
        w = jt.wavelet("Haar")
        for n in (32, 33, 1 << 16, (1 << 16) + 1):
            x = torch.from_numpy(np.random.default_rng(n).standard_normal(n))
            back = jt.swt_inverse(jt.swt_forward(x, w), w)
            assert float((back - x).abs().max()) <= 1e-8

    def test_even_non_pow2_is_corrupt(self):
        w = jt.wavelet("Haar")
        x = torch.from_numpy(np.random.default_rng(42).standard_normal(42))
        back = jt.swt_inverse(jt.swt_forward(x, w), w)
        assert float((back - x).abs().max()) > 0.1

    def test_strict_raises_on_bad_lengths(self):
        w = jt.wavelet("Haar")
        for n in (42, 6, 43):
            x = torch.zeros(n, dtype=torch.float64)
            with pytest.raises(jt.NotValid):
                jt.swt_forward(x, w, strict=True)
            with pytest.raises(jt.NotValid):
                jt.swt_inverse(x, w, strict=True)

    def test_strict_accepts_good_lengths(self):
        w = jt.wavelet("Haar")
        for n in (32, 33, 2, 9, 1):
            x = torch.from_numpy(np.random.default_rng(n).standard_normal(n))
            y = jt.swt_forward(x, w, strict=True)
            back = jt.swt_inverse(y, w, strict=True)
            assert float((back - x).abs().max()) <= 1e-8


def test_swt_odd_passthrough_and_gradient():
    """The odd trailing sample passes through, and the gradient of the
    forward matches ``jax.grad`` at f64."""
    rng = np.random.default_rng(3)
    x, wts = rng.standard_normal((2, 33)), rng.standard_normal((2, 33))
    w = jt.wavelet("Daubechies 4")
    xt = torch.from_numpy(x).requires_grad_()
    y = jt.swt_forward(xt, w)
    assert y[..., -1].tolist() == x[..., -1].tolist()
    (y * torch.from_numpy(wts)).sum().backward()
    wj = jw.wavelet("Daubechies 4")
    want = np.asarray(jax.jit(jax.grad(
        lambda v: (jarb.swt_forward(v, wj) * wts).sum()))(x))
    assert _rel(xt.grad, want) <= 1e-9


@pytest.mark.parametrize("dtype,want", [
    (np.float32, torch.float32), (np.int64, torch.float32)])
def test_dtypes(dtype, want):
    x = (np.random.default_rng(4).standard_normal((2, 600)) * 9).astype(dtype)
    w = jt.wavelet("Daubechies 4")
    for fn in ("aed_forward", "swt_forward"):
        got = getattr(jt, fn)(torch.from_numpy(x), w)
        assert got.dtype == want
        ref = np.asarray(_jax(fn, "Daubechies 4")(x.astype(np.float64)))
        assert _rel(got.double(), ref) <= 1e-5
