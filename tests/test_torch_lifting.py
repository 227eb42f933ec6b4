"""The port's lifting transforms (``ops/lifting.py``) against the JAX
package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit`` with the level static.  Tolerances:

* f64, 1e-12 × max|ref|: both run the same predict/update adds and rolls
  in float64;
* gradients at f64 against ``jax.grad``, 1e-9 relative;
* f32, 1e-5 × max|ref| (the same adds in float32); bf16 stays bf16.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.ops import lifting as jlift


@functools.lru_cache(maxsize=None)
def _jax(fn, level):
    return jax.jit(lambda x: getattr(jlift, fn)(x, level))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got, dtype=want.dtype) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("scheme", ["cdf53", "cdf97"])
@pytest.mark.parametrize("shape,level", [((1024,), None), ((2, 3, 512), 4),
                                         ((4, 256), 1), ((2, 64), 0),
                                         ((2,), None)])
def test_forward_and_inverse_match_jax_f64(scheme, shape, level):
    x = np.random.default_rng(len(shape) * 7 + (level or 9)).standard_normal(
        shape)
    want = np.array(_jax(scheme, level)(x))
    got = getattr(jt, scheme)(torch.from_numpy(x), level)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-12
    inv = "i" + scheme
    back_want = np.asarray(_jax(inv, level)(want))
    back = getattr(jt, inv)(torch.from_numpy(want), level)
    assert _rel(back.numpy(), back_want) <= 1e-12
    assert float(np.abs(back.numpy() - x).max()) <= 1e-10


def test_lifting_entry_points_and_power_of_two():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 128)))
    assert torch.equal(jt.lifting_fwt(x, "cdf53", 3), jt.cdf53(x, 3))
    assert torch.equal(jt.lifting_ifwt(x, "cdf97", 2), jt.icdf97(x, 2))
    with pytest.raises(jt.NotValid):
        jt.cdf97(torch.zeros(100))
    with pytest.raises(KeyError):
        jt.lifting_fwt(x, "cdf22")


def test_cdf97_gradient_matches_jax_f64():
    rng = np.random.default_rng(3)
    x, wts = rng.standard_normal((2, 256)), rng.standard_normal((2, 256))
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(jlift.cdf97(v, 5) * wts)))(x))
    xt = torch.from_numpy(x).requires_grad_()
    (jt.cdf97(xt, 5) * torch.from_numpy(wts)).sum().backward()
    assert _rel(xt.grad.numpy(), want) <= 1e-9


@pytest.mark.parametrize("dtype,want", [
    (np.float32, torch.float32), (np.int32, torch.float32)])
def test_dtypes_f32_and_int(dtype, want):
    """float32 stays float32 (within 1e-5 of the JAX result); integer input
    is transformed in torch's default float dtype (JAX under x64 promotes
    it to float64: the values agree within float32 rounding)."""
    x = (np.random.default_rng(4).standard_normal((3, 256)) * 8).astype(dtype)
    got = jt.cdf97(torch.from_numpy(x), 4)
    assert got.dtype == want
    assert _rel(got.numpy(), _jax("cdf97", 4)(x)) <= 1e-5


def test_bf16_stays_bf16():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 256))).to(torch.bfloat16)
    y = jt.cdf53(x, 3)
    assert y.dtype == torch.bfloat16
    want = jt.cdf53(x.double(), 3)
    assert float((y.double() - want).abs().max()) <= 5e-2 * float(
        want.abs().max())
