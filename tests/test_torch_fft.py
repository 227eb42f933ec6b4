"""The port's Fourier transforms (``ops/fft.py``) against the JAX
package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit``.  Tolerances: f64/complex128, 1e-12 × max|ref| (both
run pocketfft, or the same DFT matrix product, in float64); f32, 1e-5 ×
max|ref|.  The DFT matrix itself is the same host float64 arithmetic:
exactly equal.  ``pin`` tests hold the pinned product's gradients to
``torch.autograd.gradcheck`` at f64.
"""
import importlib

import numpy as np
import pytest
import torch

import jax

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

jfft = importlib.import_module("jwave_pro_tpu.ops.fft")
tfwt = importlib.import_module("jwave_pro_tpu_torch.ops.fwt")


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("fn", ["fft", "ifft", "dft", "idft"])
@pytest.mark.parametrize("shape,kind", [((64,), "real"), ((2, 3, 100), "real"),
                                        ((4, 96), "complex"),
                                        ((5, 37), "complex")])
def test_transforms_match_jax_f64(fn, shape, kind):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.standard_normal(shape)
    if kind == "complex":
        x = x + 1j * rng.standard_normal(shape)
    want = np.asarray(jax.jit(getattr(jfft, fn))(x))
    got = getattr(jt.ops, fn)(torch.from_numpy(x))
    assert got.dtype == torch.complex128 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("fn", ["fft_interleaved", "ifft_interleaved"])
def test_interleaved_match_jax_f64(fn):
    arr = np.random.default_rng(7).standard_normal((3, 128))
    want = np.asarray(jax.jit(getattr(jfft, fn))(arr))
    got = getattr(jt, fn)(torch.from_numpy(arr))
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-12


def test_dft_matrix_and_the_public_names():
    for n, inverse in ((8, False), (33, True)):
        np.testing.assert_array_equal(jt.dft_matrix(n, inverse),
                                      jfft.dft_matrix(n, inverse))
    assert jt.fft is jt.ops.fft and callable(jt.fft)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(256))
    assert _rel(jt.idft(jt.dft(x)).real.numpy(), x.numpy()) <= 1e-12
    assert _rel(jt.ifft(jt.fft(x)).real.numpy(), x.numpy()) <= 1e-12


@pytest.mark.parametrize("dtype,want", [
    (np.float32, torch.complex64), (np.float64, torch.complex128),
    (np.int32, torch.complex64)])
def test_output_dtypes(dtype, want):
    x = (np.random.default_rng(9).standard_normal((2, 64)) * 4).astype(dtype)
    for fn in ("fft", "dft"):
        got = getattr(jt, fn)(torch.from_numpy(x))
        assert got.dtype == want
        ref = np.asarray(jax.jit(getattr(jfft, fn))(x.astype(np.float64)))
        assert _rel(got.numpy(), ref) <= (1e-12 if dtype == np.float64
                                          else 1e-5)
    b = jt.fft(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    assert b.dtype == torch.complex64


def test_dft_gradient_matches_jax_f64():
    rng = np.random.default_rng(10)
    x, wts = rng.standard_normal((2, 48)), rng.standard_normal((2, 48))
    want = np.asarray(jax.jit(jax.grad(
        lambda v: (jfft.dft(v) * wts).real.sum()))(x))
    xt = torch.from_numpy(x).requires_grad_()
    (jt.dft(xt) * torch.from_numpy(wts)).real.sum().backward()
    assert _rel(xt.grad.numpy(), want) <= 1e-9


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("a_shape,b_shape", [
    ((3, 4, 5), (5, 6)), ((6, 5), (2, 5, 4)), ((5,), (5, 3))])
def test_pinned_product_gradients(tf32, a_shape, b_shape):
    """The pinned product's backward (run here on CPU tensors) is the
    adjoint of its forward for either operand, the broadcast axes summed
    back, real and complex; a 1-D left operand as ``torch.matmul`` reads
    it."""
    rng = np.random.default_rng(11)
    for cplx in (False, True):
        a = torch.from_numpy(rng.standard_normal(a_shape))
        b = torch.from_numpy(rng.standard_normal(b_shape))
        if cplx:
            a = a + 1j * torch.from_numpy(rng.standard_normal(a_shape))
            b = b + 1j * torch.from_numpy(rng.standard_normal(b_shape))
        a.requires_grad_()
        b.requires_grad_()
        if len(a_shape) == 1:
            fn = lambda u, v: tfwt.f32_mm(  # noqa: E731
                u[None], v, int(tf32))[..., 0, :]
        else:
            fn = lambda u, v: tfwt.f32_mm(u, v, int(tf32))  # noqa: E731
        torch.testing.assert_close(fn(a, b), torch.matmul(a, b), rtol=0,
                                   atol=1e-12)
        assert torch.autograd.gradcheck(fn, (a, b))
