"""The port's pruned-band CWT (``ops/cwt_banded.py``, ``cwt(method=
'banded')``) against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit`` with the scales, wavelet and precision static.
Tolerances:

* port banded against JAX banded at f64, 1e-10 × max|ref|: both plan the
  same bands from ψ̂ evaluated on the host in float64 (each package with
  its own formulas, equal to a few ulps) and run the same factorized DFT
  in float64;
* port banded against the port's irfft path at f64, 5e-8 × max|ref| (the
  JAX package's own bound, ``tests/test_cwt_banded.py``: the 1e-8 band
  truncation);
* the plans: the same regime, band offsets, widths and order exactly, the
  host constants within 1e-12;
* gradients at f64 against ``jax.grad``, 1e-9 relative;
* the float32 tiers against the port's float32 irfft path, the JAX tests'
  bounds: 'highest' 2e-5 × max|ref| (its on-chip bound), 'high' 1e-3 ×
  max|ref| + 1e-6, 'default' and bfloat16 input 2e-2 × max|ref|.
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

jcwt = importlib.import_module("jwave_pro_tpu.ops.cwt")
jband = importlib.import_module("jwave_pro_tpu.ops.cwt_banded")
tcwt = importlib.import_module("jwave_pro_tpu_torch.ops.cwt")
tband = importlib.import_module("jwave_pro_tpu_torch.ops.cwt_banded")

SCALES = tuple(float(s) for s in jt.generate_log_scales(1.0, 256.0, 64))
FAMILIES = [
    (lambda p: p.MorletWavelet(), "analytic"),
    (lambda p: p.PaulWavelet(), "analytic"),
    (lambda p: p.MexicanHatWavelet(), "real"),
    (lambda p: p.DOGWavelet(2), "real"),
    (lambda p: p.DOGWavelet(1), "general"),
    (lambda p: p.DOGWavelet(3), "general"),
    (lambda p: p.MeyerWavelet(), "general"),
]
IDS = ["morlet", "paul", "mexhat", "dog2", "dog1", "dog3", "meyer"]


@functools.lru_cache(maxsize=None)
def _jax_cwt(wavelet, scales, rate, method, precision=None):
    return jax.jit(lambda x: jcwt.cwt(x, scales, wavelet, rate,
                                      method=method,
                                      precision=precision).coefficients)


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("make,mode", FAMILIES, ids=IDS)
def test_banded_matches_jax_and_the_irfft_path_f64(make, mode):
    x = np.random.default_rng(FAMILIES.index((make, mode))).standard_normal(
        (2, 4000))
    want = np.asarray(_jax_cwt(make(jw), SCALES, 1.0, "banded")(x))
    got = jt.cwt(torch.from_numpy(x), SCALES, make(jt),
                 method="banded").coefficients
    assert got.dtype == (torch.float64 if mode == "real"
                         else torch.complex128)
    assert _rel(got, want) <= 1e-10
    irfft = jt.cwt(torch.from_numpy(x), SCALES, make(jt),
                   method="fft").coefficients
    assert _rel(got, irfft.numpy()) <= 5e-8
    plan = tband.band_plan(make(jt), SCALES, 4096, 1.0, 4000)
    assert plan[0] == mode


@pytest.mark.parametrize("make,mode", FAMILIES[:5], ids=IDS[:5])
@pytest.mark.parametrize("derivative", [False, True])
def test_band_plan_matches_jax(make, mode, derivative):
    args = (SCALES, 2048, 2.5, 2000, 1e-8, derivative)
    got = tband.band_plan(make(jt), *args)
    want = jband.band_plan(make(jw), *args)
    assert got[0] == want[0] == mode
    assert len(got[1]) == len(want[1])
    for gs, ws in zip(got[1], want[1]):
        for g, w in zip(gs, ws):
            assert g.offsets == w.offsets and g.b2 == w.b2
            peak = np.abs(w.mult).max()
            assert np.abs(g.mult - w.mult).max() <= 1e-12 * peak
            np.testing.assert_allclose(g.twc, w.twc, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g, w)
    assert got[5:] == want[5:]


def test_descending_grid_and_batch_axes():
    """A descending grid takes the inverse-permutation path; leading axes
    (B1, B2, N) batch."""
    x = np.random.default_rng(3).standard_normal((2, 3, 3000))
    sd = SCALES[::-1]
    want = np.asarray(_jax_cwt(jw.MorletWavelet(), sd, 2.5, "banded")(x))
    r = jt.cwt(torch.from_numpy(x), np.asarray(sd), jt.MorletWavelet(), 2.5,
               method="banded")
    assert r.coefficients.shape == (2, 3, 64, 3000)
    assert _rel(r.coefficients, want) <= 1e-10
    assert torch.equal(r.scales, torch.tensor(sd, dtype=torch.float64))
    fft = jt.cwt(torch.from_numpy(x), np.asarray(sd), jt.MorletWavelet(),
                 2.5, method="fft").coefficients
    assert _rel(r.coefficients, fft.numpy()) <= 5e-8
    assert tband._device_plan(tband._plan_key(
        jt.MorletWavelet(), sd, 4096, 2.5, 3000), torch.float64,
        torch.device("cpu"))[2] is not None


@pytest.mark.parametrize("make", [FAMILIES[0][0], FAMILIES[2][0],
                                  FAMILIES[4][0]], ids=["morlet", "mexhat",
                                                        "dog1"])
def test_banded_wd_matches_jax_f64(make):
    x = np.random.default_rng(4).standard_normal((2, 1000))
    xp = np.pad(x, ((0, 0), (0, 24)))
    xh = np.fft.rfft(xp, axis=-1)
    scales = SCALES[::4]
    w_want, dw_want = jax.jit(lambda v: jband.cwt_banded_wd(
        v, 1000, np.asarray(scales), make(jw), 1.0, 1024))(xh)
    w, dw = jt.cwt_banded_wd(torch.from_numpy(xh), 1000, np.asarray(scales),
                             make(jt), 1.0, 1024)
    assert w.dtype == dw.dtype == torch.complex128
    assert _rel(w, w_want) <= 1e-10
    assert _rel(dw, dw_want) <= 1e-10


def test_banded_gradient_matches_jax_f64():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1000))
    wts = rng.standard_normal((2, 16, 1000))
    scales = tuple(float(s) for s in jt.generate_log_scales(1.0, 64.0, 16))

    def jloss(v):
        c = jcwt.cwt(v, scales, jw.MorletWavelet(), method="banded")
        return jnp.sum(jnp.abs(c.coefficients) * wts)

    want = np.asarray(jax.jit(jax.grad(jloss))(x))
    xt = torch.from_numpy(x).requires_grad_()
    c = jt.cwt(xt, scales, jt.MorletWavelet(), method="banded").coefficients
    (c.abs() * torch.from_numpy(wts)).sum().backward()
    assert _rel(xt.grad, want) <= 1e-9


def test_guards_and_precision_mapping():
    assert not jt.banded_supported(256, 256)
    assert jt.banded_supported(512, 300) and not jt.banded_supported(640, 0)
    assert jt.banded_supported(640, 1)
    x = torch.zeros(2, 200, dtype=torch.float64)
    with pytest.raises(ValueError, match="banded CWT needs"):
        jt.cwt(x, SCALES[:4], method="banded")
    assert tcwt._resolve_precision(None, False) == "highest"
    assert tcwt._resolve_precision(None, True) == "high"
    assert tcwt._resolve_precision("HIGH", False) == "high"
    assert tcwt._resolve_precision("default", True) == "default"
    with pytest.raises(ValueError, match="precision"):
        tcwt._resolve_precision("bogus", False)


@pytest.mark.parametrize("precision,bound", [
    (None, (2e-5, 0.0)), ("highest", (2e-5, 0.0)), ("high", (1e-3, 1e-6)),
    ("default", (2e-2, 0.0))])
def test_float32_tiers_within_the_jax_bounds(precision, bound):
    wav = jt.MorletWavelet.from_omega0(6.0)
    scales = jt.generate_log_scales(1.0, 64.0, 16)
    x = np.random.default_rng(6).standard_normal((2, 1024)).astype(np.float32)
    ref = jt.cwt(torch.from_numpy(x), scales, wav, 100.0).coefficients
    got = jt.cwt(torch.from_numpy(x), scales, wav, 100.0, method="banded",
                 precision=precision).coefficients
    assert got.dtype == torch.complex64
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bound[0] * scale + bound[1]
    if precision == "default":
        # the bf16 operand rounding shows: the tier is not the exact one
        assert float((got - ref).abs().max()) > 1e-5 * scale


def test_bf16_input_takes_the_high_tier():
    wav = jt.MorletWavelet.from_omega0(6.0)
    scales = jt.generate_log_scales(1.0, 64.0, 16)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 1024)).astype(np.float32))
    ref = jt.cwt(x, scales, wav, 100.0).coefficients
    b16 = jt.cwt(x.to(torch.bfloat16), scales, wav, 100.0,
                 method="banded")
    assert b16.coefficients.dtype == torch.complex64
    assert float((b16.coefficients - ref).abs().max()) <= 2e-2 * float(
        ref.abs().max())
    want = jt.cwt(x.to(torch.bfloat16), scales, wav, 100.0, method="banded",
                  precision="high").coefficients
    assert torch.equal(b16.coefficients, want)
    # int input: float32, complex64 out (Mexican Hat: real float32)
    i = jt.cwt(torch.arange(1024) % 7, scales, jt.MexicanHatWavelet(),
               method="banded")
    assert i.coefficients.dtype == torch.float32
