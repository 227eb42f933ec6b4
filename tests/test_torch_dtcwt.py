"""The port's dual-tree complex wavelet transform (``ops/dtcwt.py``)
against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit`` with the level, the level-1 wavelet and the q-shift
parameters static.  Tolerances:

* the q-shift design: exactly equal (the same float64 host arithmetic);
* 1D and 2D forward and inverse at f64, 1e-10 × max|ref|: both run the
  same banded products against the same host constants in float64, in
  another summation order;
* the denoisers at f64, 1e-10 × max|ref| (the midpoint median, as
  ``jnp.median``);
* gradients at f64 against ``jax.grad``, 1e-9 relative;
* float32, 1e-5 × max|ref|.

N = 2^level leaves no block pair (the fused form does not fit), so single
steps run; N = 1024 at level 5 runs the fused form in one chunk and
N = 4096 at level 7 in two.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

jdt = importlib.import_module("jwave_pro_tpu.ops.dtcwt")
tdt = importlib.import_module("jwave_pro_tpu_torch.ops.dtcwt")

TOL = 1e-10


@functools.lru_cache(maxsize=None)
def _jax(fn, *static):
    return jax.jit(lambda x: getattr(jdt, fn)(x, *static))


def _level1(name):
    return (None, None) if name is None else (jw.wavelet(name),
                                              jt.wavelet(name))


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_qshift_design_is_the_same_host_arithmetic():
    for k, l in ((4, 3), (3, 2), (2, 1)):
        for a, b in zip(tdt.qshift_design(k, l), jdt.qshift_design(k, l)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tdt.qshift_wavelets(k, l), jdt.qshift_wavelets(k, l)):
            assert a.name == b.name and a.length == b.length
            np.testing.assert_array_equal(a.dec_hi, b.dec_hi)
    with pytest.raises(ValueError):
        jt.qshift_design(0, 3)


@pytest.mark.parametrize("shape,level,name,kl", [
    ((2, 1024), 5, None, (4, 3)),          # fused, one chunk
    ((2, 3, 4096), 7, None, (4, 3)),       # fused, two chunks
    ((2, 512), 3, "Daubechies 4", (3, 2)),
    ((3, 64), 6, None, (4, 3)),            # N = 2^level: single steps
    ((2, 768), 2, "Haar", (4, 3)),         # 768 = 3·256: block pairs
    ((2, 96), 4, None, (2, 1)),            # roll-form steps
])
def test_dtcwt_and_inverse_match_jax_f64(shape, level, name, kl):
    wj, wt = _level1(name)
    x = np.random.default_rng(shape[-1] + level).standard_normal(shape)
    want = _jax("dtcwt", level, wj, *kl)(x)
    got = jt.dtcwt(torch.from_numpy(x), level, wt, *kl)
    assert len(got.highpass) == level
    for g, w in zip(got.highpass, want.highpass):
        assert g.dtype == torch.complex128
        assert _rel(g, w) <= TOL
    assert _rel(got.lowpass_a, want.lowpass_a) <= TOL
    assert _rel(got.lowpass_b, want.lowpass_b) <= TOL
    back_want = np.asarray(_jax("idtcwt", wj, *kl)(want))
    res = tdt.DTCWTResult(tuple(torch.from_numpy(np.array(h))
                                for h in want.highpass),
                          torch.from_numpy(np.array(want.lowpass_a)),
                          torch.from_numpy(np.array(want.lowpass_b)))
    back = jt.idtcwt(res, wt, *kl)
    assert _rel(back, back_want) <= TOL
    assert float(np.abs(back.numpy() - x).max()) <= 1e-9


@pytest.mark.parametrize("shape,level,name", [
    ((2, 64, 64), 3, None), ((2, 128, 256), 2, "Daubechies 4"),
    ((16, 32), 2, None), ((1, 2, 8, 8), 3, None)])
def test_dtcwt2_and_inverse_match_jax_f64(shape, level, name):
    wj, wt = _level1(name)
    x = np.random.default_rng(shape[-1] * level).standard_normal(shape)
    want = _jax("dtcwt2", level, wj)(x)
    got = jt.dtcwt2(torch.from_numpy(x), level, wt)
    for g, w in zip(got.highpass, want.highpass):
        assert g.dtype == torch.complex128
        assert _rel(g, w) <= TOL
    assert _rel(got.lowpass, want.lowpass) <= TOL
    back_want = np.asarray(_jax("idtcwt2", wj)(want))
    res = tdt.DTCWT2Result(tuple(torch.from_numpy(np.array(h))
                                 for h in want.highpass),
                           torch.from_numpy(np.array(want.lowpass)))
    back = jt.idtcwt2(res, wt)
    assert _rel(back, back_want) <= TOL
    assert float(np.abs(back.numpy() - x).max()) <= 1e-9


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("threshold", [None, 0.7])
def test_denoisers_match_jax_f64(mode, threshold):
    rng = np.random.default_rng(5)
    t = np.linspace(0, 1, 1024)
    x = np.sin(2 * np.pi * 5 * t) + 0.3 * rng.standard_normal((4, 1024))
    want = np.asarray(jax.jit(lambda v: jdt.dtcwt_denoise(
        v, 4, mode, threshold))(x))
    got = jt.dtcwt_denoise(torch.from_numpy(x), 4, mode, threshold)
    assert _rel(got, want) <= TOL
    img = rng.standard_normal((2, 64, 64)) + np.outer(t[:64], t[:64])
    want2 = np.asarray(jax.jit(lambda v: jdt.dtcwt2_denoise(
        v, 2, mode, threshold))(img))
    got2 = jt.dtcwt2_denoise(torch.from_numpy(img), 2, mode, threshold)
    assert _rel(got2, want2) <= TOL


def test_denoise_threshold_uses_the_midpoint_median():
    """An even count of level-1 details: the universal threshold takes the
    midpoint of the two middle values (``jnp.median``), not the lower one
    (``torch.median``)."""
    x = np.random.default_rng(6).standard_normal((3, 256))
    r = jt.dtcwt(torch.from_numpy(x), 3)
    t = tdt._universal_complex_threshold(r.highpass[0], 256, axes=-1)
    d = np.sqrt(2.0) * r.highpass[0].real.numpy()
    med = np.median(d, axis=-1, keepdims=True)
    want = np.median(np.abs(d - med), axis=-1, keepdims=True) / 0.6745 \
        * np.sqrt(2.0 * np.log(256))
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-14)
    assert d.shape[-1] % 2 == 0


def test_dtcwt_roundtrip_gradient_matches_jax_f64():
    rng = np.random.default_rng(7)
    x, wts = rng.standard_normal((2, 1024)), rng.standard_normal((2, 1024))
    hw = [rng.standard_normal((2, 1024 >> j)) for j in range(1, 6)]

    def jloss(v):
        r = jdt.dtcwt(v, 5)
        s = sum(jnp.sum(jnp.abs(h) * w) for h, w in zip(r.highpass, hw))
        return s + jnp.sum(jdt.idtcwt(r) * wts)

    want = np.asarray(jax.jit(jax.grad(jloss))(x))
    xt = torch.from_numpy(x).requires_grad_()
    r = jt.dtcwt(xt, 5)
    loss = sum((h.abs() * torch.from_numpy(w)).sum()
               for h, w in zip(r.highpass, hw))
    (loss + (jt.idtcwt(r) * torch.from_numpy(wts)).sum()).backward()
    assert _rel(xt.grad, want) <= 1e-9


def test_errors():
    x = torch.zeros(2, 96, dtype=torch.float64)
    with pytest.raises(ValueError, match="divisible"):
        jt.dtcwt(x, 6)                      # 96 % 64 != 0
    with pytest.raises(ValueError, match="real signal"):
        jt.dtcwt(x.to(torch.complex128), 2)
    with pytest.raises(ValueError, match="level"):
        jt.dtcwt(x, 0)
    with pytest.raises(ValueError, match="real image"):
        jt.dtcwt2(torch.zeros(8, 8, dtype=torch.complex64), 1)
    with pytest.raises(ValueError, match="divisible"):
        jt.dtcwt2(torch.zeros(8, 12), 3)
    with pytest.raises(ValueError, match="at least"):
        jt.dtcwt2(torch.zeros(16), 1)
    with pytest.raises(ValueError, match="mode"):
        jt.dtcwt_denoise(torch.zeros(2, 64), 2, mode="garrote")


@pytest.mark.parametrize("dtype,low,high", [
    (np.float32, torch.float32, torch.complex64),
    (np.float64, torch.float64, torch.complex128),
    (np.int32, torch.float32, torch.complex64),
    ("bf16", torch.bfloat16, torch.complex64)])
def test_output_dtypes(dtype, low, high):
    x = np.random.default_rng(8).standard_normal((2, 3, 512)) * 4
    xt = (torch.from_numpy(x).to(torch.bfloat16) if dtype == "bf16"
          else torch.from_numpy(x.astype(dtype)))
    r = jt.dtcwt(xt, 3)
    assert r.lowpass_a.dtype == low and r.highpass[0].dtype == high
    assert r.highpass[0].shape == (2, 3, 256)
    back = jt.idtcwt(r)
    assert back.dtype == low and back.shape == xt.shape
    want = jt.dtcwt(xt.double(), 3)
    tol = 5e-2 if dtype == "bf16" else 1e-5
    for g, w in zip(r.highpass, want.highpass):
        assert _rel(g.to(torch.complex128), w.numpy()) <= tol
    r2 = jt.dtcwt2(xt[..., :64].reshape(2, 3, 8, 8), 2)
    assert r2.lowpass.dtype == low and r2.highpass[0].dtype == high
    assert r2.lowpass.shape == (2, 3, 4, 2, 2)
