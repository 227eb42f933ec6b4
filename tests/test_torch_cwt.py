"""The port's continuous wavelets and FFT CWT against the JAX package's, on
the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* ψ and ψ̂ at f64, 1e-12 absolute: the same closed forms in float64.
* ``cwt`` 'fft'/'auto' at f64, 1e-10 relative to max|c|: both evaluate ψ̂
  on the host in float64 and run a float64 rfft/irfft pair (pocketfft on
  both sides, in another order).
* the complex-input path, 1e-6 relative: both packages compute it in
  complex64 (the JAX package's dtype rule, copied).
* ``cwt`` 'auto' on the CPU bitwise 'fft': the kernel runs only on the
  card, where ``tests/test_torch_kernels.py`` holds 'auto' to 'fused'.
* ``cwt_ifft_plain`` and ``cwt(method='fused')`` against the JAX package's
  interpret-mode Pallas kernel, f32, 5e-4 absolute: the bound
  ``tests/test_pallas_kernels.py`` holds that kernel to (its 3-pass bf16
  split loses ~2⁻¹⁶ a product); the plain version's own algorithm is held
  to ``numpy.fft.ifft`` at complex128, 1e-12.
* ``cwt(method='banded')`` against the JAX package's banded path, and
  ``cwt_direct`` and ``icwt`` against the JAX package's, at f64, 1e-10
  relative to max|ref|: the same host float64 constants (ψ̂ and ψ through
  each package's own formulas) and the same float64 products, FFTs and
  sums in another order.  ``cwt_direct`` of float32 input, 1e-5 relative
  to the f64 result (its taps rounded to float32).
"""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch._subclasses.fake_tensor import FakeTensorMode

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.cwt_pallas import (
    cwt_fused_supported as jax_fused_supported,
)
from jwave_pro_tpu.ops.cwt import pad_signal as jax_pad_signal
from jwave_pro_tpu_torch.kernels import cwt_cuda as kc
from jwave_pro_tpu_torch.kernels._launch import LAUNCHES

# the module (``jwave_pro_tpu_torch.ops.cwt`` names the function)
tcwt = importlib.import_module("jwave_pro_tpu_torch.ops.cwt")

# (JAX wavelet, port wavelet) for each family and a few parameters
PAIRS = [
    (lambda p: p.MorletWavelet(), "Morlet"),
    (lambda p: p.MorletWavelet(1.5, 0.8), "Morlet(1.5, 0.8)"),
    (lambda p: p.MorletWavelet.from_omega0(6.0), "Morlet ω0=6"),
    (lambda p: p.MexicanHatWavelet(1.3), "Mexican Hat"),
    (lambda p: p.PaulWavelet(4), "Paul 4"),
    (lambda p: p.DOGWavelet(1), "DOG 1"),
    (lambda p: p.DOGWavelet(3, 0.7), "DOG 3"),
    (lambda p: p.DOGWavelet(4), "DOG 4"),
    (lambda p: p.MeyerWavelet(), "Meyer"),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# -- continuous wavelets ------------------------------------------------------

@pytest.mark.parametrize("make,label", PAIRS)
def test_psi_and_psi_hat_match_jax_f64(make, label):
    wj, wt = make(jw), make(jt)
    t = np.linspace(-12.0, 12.0, 257)
    om = np.linspace(-20.0, 20.0, 401)
    pairs = [
        (wj.psi(jnp.asarray(t)), wt.psi(_t(t))),
        (wj.psi_hat(jnp.asarray(om)), wt.psi_hat(_t(om))),
        (wj.psi_scaled(jnp.asarray(t), 2.5, 0.5),
         wt.psi_scaled(_t(t), 2.5, 0.5)),
        (wj.psi_hat_scaled(jnp.asarray(om)[None, :],
                           jnp.asarray([[0.5], [3.0]]), 0.25),
         wt.psi_hat_scaled(_t(om)[None, :], _t([[0.5], [3.0]]), 0.25)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12, err_msg=label)
    assert wt.name == wj.name
    assert wt.center_frequency == pytest.approx(wj.center_frequency,
                                                rel=1e-15)
    assert wt.admissibility_constant() == wj.admissibility_constant()
    assert wt.effective_support() == wj.effective_support()
    assert wt.bandwidth() == wj.bandwidth()
    assert wt.scale_to_frequency(4.0, 2.0) == wj.scale_to_frequency(4.0, 2.0)


def test_wavelets_are_hashable_values_and_validate():
    assert jt.MorletWavelet(1.0, 1.0) == jt.MorletWavelet()
    assert hash(jt.DOGWavelet(3)) == hash(jt.DOGWavelet(3, 1.0))
    assert jt.DOGWavelet(3) != jt.DOGWavelet(4)
    assert jt.continuous_wavelet("Ricker") == jt.MexicanHatWavelet()
    assert jt.continuous_wavelet("paul", 6) == jt.PaulWavelet(6)
    assert jt.DOGWavelet.standard("ridge") == jt.DOGWavelet(4)
    sigma = jw.MexicanHatWavelet.from_center_frequency(0.25).sigma
    assert jt.MexicanHatWavelet.from_center_frequency(
        0.25).sigma == pytest.approx(sigma, rel=1e-15)
    for bad in (lambda: jt.MorletWavelet(0.0), lambda: jt.PaulWavelet(0),
                lambda: jt.DOGWavelet(11), lambda: jt.MexicanHatWavelet(-1),
                lambda: jt.continuous_wavelet("nope"),
                lambda: jt.DOGWavelet.standard("nope")):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("make", [
    lambda p: p.MorletWavelet(1.5, 0.8), lambda p: p.DOGWavelet(3, 0.7),
    lambda p: p.PaulWavelet(6), lambda p: p.MexicanHatWavelet(2.0),
    lambda p: p.MeyerWavelet(),
])
def test_from_jax_wavelet_carries_continuous_wavelets(make):
    wj = make(jw)
    wt = jt.from_jax_wavelet(wj)
    assert wt == make(jt) and type(wt).__name__ == type(wj).__name__
    omega = tcwt._omega_axis(256, 1.0)
    scales = np.array([[1.0], [4.0], [16.0]])
    want = np.asarray(wj.psi_hat_scaled(jnp.asarray(omega)[None, :],
                                        jnp.asarray(scales)))
    got = wt.psi_hat_scaled(_t(omega)[None, :], _t(scales)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# -- scales and padding -------------------------------------------------------

def test_scale_generators_match_jax():
    np.testing.assert_array_equal(jt.generate_log_scales(1.0, 256.0, 64),
                                  jw.generate_log_scales(1.0, 256.0, 64))
    np.testing.assert_array_equal(jt.generate_linear_scales(0.5, 8.0, 7),
                                  jw.generate_linear_scales(0.5, 8.0, 7))
    for args in ((0.0, 2.0, 4), (2.0, 1.0, 4), (1.0, 2.0, 1)):
        with pytest.raises(ValueError):
            jt.generate_log_scales(*args)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "periodic",
                                  "constant"])
@pytest.mark.parametrize("n,target", [(5, 16), (100, 128), (7, 7), (9, 4)])
def test_pad_signal_matches_jax(mode, n, target):
    x = np.random.default_rng(n).standard_normal((2, n))
    want = np.asarray(jax_pad_signal(jnp.asarray(x), target, mode))
    got = jt.pad_signal(_t(x), target, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="padding mode"):
        jt.pad_signal(_t(x), n + 3, "reflect")


# -- cwt ----------------------------------------------------------------------

@pytest.mark.parametrize("make,label", PAIRS)
@pytest.mark.parametrize("method", ["fft", "auto"])
def test_cwt_matches_jax_fft_f64(make, label, method):
    x = np.random.default_rng(1).standard_normal((2, 300))
    scales = jw.generate_log_scales(1.0, 48.0, 12)
    want = jw.cwt(x, scales, make(jw), sampling_rate=2.0, method="fft")
    got = jt.cwt(_t(x), scales, make(jt), sampling_rate=2.0, method=method)
    wc = np.asarray(want.coefficients)
    gc = got.coefficients.numpy()
    assert gc.dtype == wc.dtype and gc.shape == wc.shape == (2, 12, 300)
    assert _rel(gc, wc) <= 1e-10, label
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(got.time_axis.numpy(),
                                  np.asarray(want.time_axis))
    assert got.wavelet_name == want.wavelet_name
    assert got.sampling_rate == want.sampling_rate


def test_cwt_result_properties_match_jax():
    x = np.random.default_rng(2).standard_normal(200)
    scales = jw.generate_log_scales(1.0, 16.0, 6)
    want = jw.cwt(x, scales, jw.MorletWavelet(), padding="symmetric")
    got = jt.cwt(_t(x), scales, jt.MorletWavelet(), padding="symmetric")
    for name in ("magnitude", "phase", "real", "imag", "scalogram"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(got.scale_to_frequency(1.0).numpy(),
                               np.asarray(want.scale_to_frequency(1.0)),
                               rtol=1e-15)
    real = jt.cwt(_t(x), scales, jt.MexicanHatWavelet())
    assert not real.coefficients.is_complex()
    torch.testing.assert_close(real.imag, torch.zeros_like(real.real))


def test_cwt_padding_modes_and_batch_axes():
    x = np.random.default_rng(3).standard_normal((2, 3, 100))
    scales = np.array([2.0, 5.0, 11.0])
    for mode in ("zero", "symmetric", "periodic", "constant"):
        want = np.asarray(jw.cwt(x, scales, jw.MorletWavelet(),
                                 padding=mode).coefficients)
        got = jt.cwt(_t(x), scales, jt.MorletWavelet(),
                     padding=mode).coefficients.numpy()
        assert got.shape == (2, 3, 3, 100)
        assert _rel(got, want) <= 1e-10, mode


def test_cwt_complex_input_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 100)) + 1j * rng.standard_normal((2, 100))
    scales = jw.generate_log_scales(1.0, 32.0, 8)
    for make in (lambda p: p.MorletWavelet(), lambda p: p.DOGWavelet(2)):
        want = np.asarray(jw.cwt(x, scales, make(jw)).coefficients)
        got = jt.cwt(_t(x), scales, make(jt)).coefficients.numpy()
        assert got.dtype == want.dtype == np.complex64
        assert _rel(got, want) <= 1e-6


def test_cwt_tensor_scales_match_jax_traced_scales():
    """Scales that need a gradient take the full-FFT path, the counterpart
    of the JAX package's traced scale grid."""
    x = np.random.default_rng(5).standard_normal((2, 200))
    scales = jw.generate_log_scales(1.0, 24.0, 7)
    wj = jw.MorletWavelet()
    want = np.asarray(jax.jit(lambda s: jw.cwt(x, s, wj).coefficients)(
        jnp.asarray(scales)))
    got = jt.cwt(_t(x), _t(scales).requires_grad_(), jt.MorletWavelet())
    assert got.scales.dtype == torch.float64
    assert got.coefficients.dtype == torch.complex128
    assert _rel(got.coefficients.detach().numpy(), want) <= 1e-10


@pytest.mark.parametrize("make", [lambda p: p.MexicanHatWavelet(1.3),
                                  lambda p: p.DOGWavelet(2)])
def test_cwt_scale_gradient_matches_jax(make):
    """d Σ|c|² / d scales through the full-FFT path, against ``jax.grad``
    over traced scales, 1e-9 relative (float64 in both)."""
    x = np.random.default_rng(8).standard_normal((2, 128))
    scales = np.array([1.5, 3.0, 7.0])
    wj = make(jw)
    want = np.asarray(jax.grad(lambda s: jnp.sum(jnp.abs(
        jw.cwt(x, s, wj).coefficients) ** 2))(jnp.asarray(scales)))
    s = _t(scales).requires_grad_()
    torch.sum(torch.abs(jt.cwt(_t(x), s, make(jt)).coefficients) ** 2
              ).backward()
    assert _rel(s.grad.numpy(), want) <= 1e-9


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("make,rate", [
    (lambda p: p.MexicanHatWavelet(), 1.0),
    (lambda p: p.DOGWavelet(2), 1.0),
    (lambda p: p.DOGWavelet(4), 2.0),
    (lambda p: p.MeyerWavelet(), 100.0),
])
def test_cwt_concrete_tensor_scales_dtype_matches_jax(make, rate, dtype):
    """Concrete tensor scales are static, as concrete arrays are in the JAX
    package: a real-output wavelet returns a real tensor, of JAX's dtype,
    within the file's 'fft' tolerance (1e-10 relative at f64; f32 input
    computes in float32 in both, 1e-5)."""
    x = np.random.default_rng(9).standard_normal((2, 128)).astype(dtype)
    scales = np.array([1.0, 2.0, 4.0, 9.0])
    want = jw.cwt(x, scales, make(jw), sampling_rate=rate)
    got = jt.cwt(_t(x), _t(scales), make(jt), sampling_rate=rate)
    wc, gc = np.asarray(want.coefficients), got.coefficients.numpy()
    assert gc.dtype == wc.dtype and gc.shape == wc.shape
    assert not np.iscomplexobj(gc)
    assert got.scales.numpy().dtype == np.asarray(want.scales).dtype
    assert _rel(gc, wc) <= (1e-10 if dtype == np.float64 else 1e-5)


def test_cwt_methods_and_validation():
    x = _t(np.random.default_rng(6).standard_normal(64))
    # the banded path needs a padded length of 512 or more (P = 64 here)
    with pytest.raises(ValueError, match="banded CWT needs"):
        jt.cwt(x, [2.0, 4.0], method="banded")
    with pytest.raises(ValueError, match="unknown CWT method"):
        jt.cwt(x, [2.0, 4.0], method="direct")
    with pytest.raises(ValueError, match="precision"):
        jt.cwt(x, [2.0, 4.0], precision="fast")
    # integer input computes in float32, the default wavelet is Morlet
    r = jt.cwt(torch.arange(64) % 5, [2.0, 4.0])
    assert r.coefficients.dtype == torch.complex64
    assert r.wavelet_name == "Morlet"


# -- the fused path and the kernel's plain version ----------------------------

@pytest.mark.parametrize("make", [lambda p: p.MorletWavelet(),
                                  lambda p: p.MexicanHatWavelet()])
def test_cwt_fused_matches_jax_interpret(make):
    x = np.random.default_rng(7).standard_normal((2, 512)).astype(
        np.float32)
    scales = jw.generate_log_scales(1.0, 32.0, 8)
    want = np.asarray(jw.cwt(x, scales, make(jw),
                             method="fused").coefficients)
    got = jt.cwt(_t(x), scales, make(jt), method="fused")
    assert got.coefficients.dtype == (torch.complex64 if want.dtype ==
                                      np.complex64 else torch.float32)
    assert got.scales.dtype == torch.float32
    np.testing.assert_allclose(got.coefficients.numpy(), want, rtol=0,
                               atol=5e-4)
    # the kernel's plain version on the same operands
    m, is_real = tcwt._full_spectrum_multipliers(
        make(jt), tuple(float(s) for s in scales), 512, 1.0)
    xf = torch.fft.fft(_t(x).to(torch.complex64))
    plain = kc.cwt_ifft_plain(xf, _t(m).to(torch.complex64), 512, is_real)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(plain.numpy(), got.coefficients.numpy())


@pytest.mark.parametrize("p", [64, 128, 1024, 2048, 16384])
def test_cwt_ifft_plain_is_the_inverse_dft(p):
    """The two-stage DFT at complex128 against numpy's inverse FFT."""
    rng = np.random.default_rng(p)
    xf = rng.standard_normal((2, p)) + 1j * rng.standard_normal((2, p))
    m = rng.standard_normal((3, p)) + 1j * rng.standard_normal((3, p))
    want = np.fft.ifft(xf[:, None, :] * m, axis=-1)[..., :p - 3]
    got = kc.cwt_ifft_plain(_t(xf), _t(m), p - 3, False)
    assert got.dtype == torch.complex128 and got.shape == (2, 3, p - 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    real = kc.cwt_ifft_plain(_t(xf), _t(m), p - 3, True)
    np.testing.assert_array_equal(real.numpy(), got.real.numpy())


def test_fused_gate_and_fallbacks():
    for p in (32, 64, 100, 4096, 16384, 32768):
        assert kc.cwt_fused_supported(4, 7, p) == (
            jax_fused_supported(4, 7, p) is not None), p
    x = np.random.default_rng(8).standard_normal((2, 40)).astype(np.float32)
    scales = np.array([1.5, 3.0, 6.0])
    w = jt.MorletWavelet()
    fft = jt.cwt(_t(x), scales, w, method="fft").coefficients
    # padded length 64: the fused path (the plain version on the CPU)
    fused = jt.cwt(_t(x), scales, w, method="fused").coefficients
    torch.testing.assert_close(fused, fft, rtol=0, atol=1e-5)
    # padded length 32 and float64 take the 'fft' path
    short = _t(x[:, :20])
    torch.testing.assert_close(
        jt.cwt(short, scales, w, method="fused").coefficients,
        jt.cwt(short, scales, w, method="fft").coefficients, rtol=0, atol=0)
    x64 = _t(x).double()
    torch.testing.assert_close(
        jt.cwt(x64, scales, w, method="fused").coefficients,
        jt.cwt(x64, scales, w, method="fft").coefficients, rtol=0, atol=0)
    before = LAUNCHES["cwt_ifft"]
    jt.cwt(_t(x), scales, w, method="fused")
    assert LAUNCHES["cwt_ifft"] == before


def _fake(shape, dtype=torch.float32, grad=False, device="cuda"):
    return torch.empty(shape, device=device, dtype=dtype).requires_grad_(grad)


_SCALES = np.geomspace(1.0, 64.0, 8)

# (signal, scales) -> the path method='auto' takes, with gradients on
# unless the third item turns them off; on fake tensors, CUDA unless named
AUTO_DECISIONS = {
    **{f"{dt}, P = {p}": (lambda dt=dt, p=p: (_fake((3, p), dt), _SCALES),
                          "fused")
       for dt in (torch.float32, torch.bfloat16, torch.float16)
       for p in (64, 1024, 16384)},
    "float32, n = 1000 pads to 1024": (
        lambda: (_fake((2, 5, 1000)), _SCALES), "fused"),
    "float32, one signal": (lambda: (_fake((16384,)), [4.0]), "fused"),
    "float32, concrete tensor scales": (
        lambda: (_fake((3, 1024)), torch.ones(8)), "fused"),
    "float32, x needs a gradient, gradients off": (
        lambda: (_fake((3, 1024), grad=True), _SCALES), "fused",
        {"grad": False}),
    "float64": (lambda: (_fake((3, 1024), torch.float64), _SCALES), "fft"),
    "complex64": (lambda: (_fake((3, 1024), torch.complex64), _SCALES),
                  "fft"),
    "x needs a gradient": (lambda: (_fake((3, 1024), grad=True), _SCALES),
                           "fft"),
    "scales need a gradient": (
        lambda: (_fake((3, 1024)), torch.ones(8, requires_grad=True)),
        "fft"),
    "P = 32": (lambda: (_fake((3, 32)), _SCALES), "fft"),
    "P = 32768": (lambda: (_fake((3, 20000)), _SCALES), "fft"),
    "no signals": (lambda: (_fake((0, 1024)), _SCALES), "fft"),
    "CPU tensor": (lambda: (_fake((3, 1024), device="cpu"), _SCALES), "fft"),
}


@pytest.mark.parametrize("case", sorted(AUTO_DECISIONS))
def test_auto_rule_decides_from_the_input(case):
    """What method='auto' takes is a function of the signal's device,
    dtype, batch and padded length, whether a gradient is wanted of it,
    and whether the scales need one: the kernel where it gives the
    answer, else the irfft path."""
    make, want, *how = AUTO_DECISIONS[case]
    how = how[0] if how else {}
    with FakeTensorMode(), torch.set_grad_enabled(how.get("grad", True)):
        x, scales = make()
        assert tcwt._auto_method(x, scales) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("make", [lambda p: p.MorletWavelet(),
                                  lambda p: p.MexicanHatWavelet()],
                         ids=["Morlet", "Mexican Hat"])
def test_auto_on_the_cpu_is_the_fft_path_bitwise(make, dtype):
    x = _t(np.random.default_rng(9).standard_normal((3, 1000))).to(dtype)
    scales = jt.generate_log_scales(1.0, 32.0, 6)
    before = LAUNCHES["cwt_ifft"]
    auto = jt.cwt(x, scales, make(jt))
    fft = jt.cwt(x, scales, make(jt), method="fft")
    assert torch.equal(auto.coefficients, fft.coefficients)
    assert torch.equal(auto.scales, fft.scales)
    assert LAUNCHES["cwt_ifft"] == before


def test_cwt_ifft_launcher_rejects_cpu_and_bad_operands():
    xf = torch.zeros(2, 64, dtype=torch.complex64)
    m = torch.zeros(3, 64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.cwt_ifft_cuda(xf, m, 64, False)
    out = kc.cwt_ifft_fused(xf, m, 60, True)
    assert out.shape == (2, 3, 60) and out.dtype == torch.float32
    assert kc._factor_p(4096) == (32, 128) and kc._factor_p(256) == (16, 16)
    assert math.prod(kc._factor_p(128)) == 128


@pytest.mark.parametrize("p", [64, 1024, 16384])
def test_cwt_kernel_twiddle_table(p):
    """The kernel's twiddles: e^{2πit/P} in float64, rounded once to
    complex64, one cached table per P and device."""
    tw = kc.twiddles(p, torch.device("cpu"))
    assert tw.dtype == torch.complex64 and tw.shape == (p,)
    want = np.exp(2j * np.pi * np.arange(p) / p).astype(np.complex64)
    np.testing.assert_array_equal(tw.numpy(), want)
    assert kc.twiddles(p, torch.device("cpu")) is tw


# -- the banded path, cwt_direct and icwt --------------------------------------

@pytest.mark.parametrize("make,label", PAIRS)
def test_cwt_banded_matches_jax_banded_f64(make, label):
    x = np.random.default_rng(12).standard_normal((2, 700))
    scales = tuple(float(s) for s in jw.generate_log_scales(1.0, 48.0, 12))
    want = jax.jit(lambda v: jw.cwt(v, scales, make(jw), 2.0,
                                    method="banded").coefficients)(x)
    got = jt.cwt(_t(x), scales, make(jt), 2.0, method="banded").coefficients
    assert got.numpy().dtype == np.asarray(want).dtype
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-10, label


@pytest.mark.parametrize("make,label", [PAIRS[0], PAIRS[3], PAIRS[4],
                                        PAIRS[5], PAIRS[8]])
@pytest.mark.parametrize("rate", [1.0, 2.5])
def test_cwt_direct_matches_jax_f64(make, label, rate):
    x = np.random.default_rng(13).standard_normal((2, 3, 160))
    scales = tuple(float(s) for s in jw.generate_log_scales(1.0, 24.0, 6))
    want = jax.jit(lambda v: jw.cwt_direct(v, scales, make(jw),
                                           rate).coefficients)(x)
    got = jt.cwt_direct(_t(x), np.asarray(scales), make(jt), rate)
    assert got.coefficients.dtype == torch.complex128
    assert got.coefficients.shape == (2, 3, 6, 160)
    assert _rel(got.coefficients.numpy(), np.asarray(want)) <= 1e-10, label
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(scales))


def test_cwt_direct_complex_float32_and_large_scales():
    """Complex input, float32 input (complex64 out) and a scale whose
    support exceeds the signal (the offsets clip to ±(N − 1))."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 90)) + 1j * rng.standard_normal((2, 90))
    scales = (1.5, 6.0, 80.0)
    want = np.asarray(jax.jit(lambda v: jw.cwt_direct(
        v, scales).coefficients)(x))
    got = jt.cwt_direct(_t(x), scales).coefficients.numpy()
    assert _rel(got, want) <= 1e-10
    xr = rng.standard_normal((2, 90)).astype(np.float32)
    g32 = jt.cwt_direct(_t(xr), scales)
    assert g32.coefficients.dtype == torch.complex64
    g64 = jt.cwt_direct(_t(xr).double(), scales).coefficients
    assert _rel(g32.coefficients.numpy(), g64.numpy()) <= 1e-5
    assert jt.cwt_direct(torch.arange(90) % 4, scales
                         ).coefficients.dtype == torch.complex64


@pytest.mark.parametrize("make,label", [PAIRS[0], PAIRS[3], PAIRS[4],
                                        PAIRS[6], PAIRS[8]])
def test_icwt_matches_jax_f64(make, label):
    x = np.random.default_rng(15).standard_normal((2, 500))
    scales = jw.generate_log_scales(1.0, 64.0, 40)
    want_r = jw.cwt(x, scales, make(jw), 2.0)
    want = np.asarray(jw.icwt(want_r, make(jw)))
    res = jt.cwt(_t(x), scales, make(jt), 2.0)
    got = jt.icwt(res, make(jt))
    assert got.dtype == torch.float64 and got.shape == (2, 500)
    assert _rel(got.numpy(), want) <= 1e-10, label
    # the grid given as scales= (the JAX package's form under jit)
    got2 = jt.icwt(res, make(jt), scales=tuple(scales))
    torch.testing.assert_close(got2, got, rtol=0, atol=0)
    filt, p = tcwt._recon_filter(make(jt), tuple(float(a) for a in scales),
                                 500, 2.0)
    jfilt, jp = importlib.import_module("jwave_pro_tpu.ops.cwt")._recon_filter(
        make(jw), tuple(float(a) for a in scales), 500, 2.0)
    assert p == jp == 512
    assert np.abs(filt - jfilt).max() <= 1e-12 * np.abs(jfilt).max()


def test_float16_input_is_wider_than_jax():
    """``cwt`` and ``icwt`` of float16 input: the JAX package raises
    ``ValueError`` (its rfft takes float32 or float64 only), so it forms
    neither; the port computes in float32, within the float32 bound (1e-5
    relative) of the JAX package's float64 result on the same rounded
    input."""
    x16 = np.random.default_rng(16).standard_normal((2, 500)).astype(
        np.float16)
    scales = jw.generate_log_scales(1.0, 64.0, 40)
    with pytest.raises(ValueError, match="float32 or float64"):
        jw.cwt(jnp.asarray(x16), scales, jw.MorletWavelet(), 2.0)
    want = jw.cwt(x16.astype(np.float64), scales, jw.MorletWavelet(), 2.0)
    got = jt.cwt(_t(x16), scales, jt.MorletWavelet(), 2.0)
    assert got.coefficients.dtype == torch.complex64
    assert _rel(got.coefficients.numpy(),
                np.asarray(want.coefficients)) <= 1e-5
    back = jt.icwt(got)
    assert back.dtype == torch.float32
    assert _rel(back.numpy(),
                np.asarray(jw.icwt(want, jw.MorletWavelet()))) <= 1e-5


@pytest.mark.parametrize("dtype,eps", [(np.float16, 2.0 ** -11),
                                       ("bfloat16", 2.0 ** -8)])
def test_icwt_of_half_precision_coefficients_matches_jax(dtype, eps):
    """A ``CWTResult`` whose real coefficients are float16 or bfloat16:
    both packages return float32.  The JAX package sums the scales in the
    half dtype (about one unit of it off: bound 4 units of max|ref|); the
    port sums and transforms in float32 (1e-5 relative of its float64
    result on the same coefficients)."""
    x = np.random.default_rng(17).standard_normal((2, 500))
    scales = jw.generate_log_scales(1.0, 64.0, 40)
    wav = (jw.MexicanHatWavelet(1.3), jt.MexicanHatWavelet(1.3))
    jres = jw.cwt(x, scales, wav[0], 2.0)
    jhalf = jres.coefficients.astype(jnp.dtype(dtype))
    want = np.asarray(jw.icwt(jres._replace(coefficients=jhalf), wav[0]))
    tres = jt.cwt(_t(x), scales, wav[1], 2.0)
    half = torch.from_numpy(np.array(jhalf.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))
    got = jt.icwt(tres._replace(coefficients=half), wav[1])
    ref = jt.icwt(tres._replace(coefficients=half.double()), wav[1])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert _rel(got.numpy(), ref.numpy()) <= 1e-5
    assert _rel(got.numpy(), want) <= 4 * eps


def test_icwt_reconstructs_a_band_limited_signal():
    """Round trip inside the covered band (the method's own accuracy:
    the JAX tests pin ≤ 5% relative L2 for every family)."""
    t = np.arange(2048)
    x = np.sin(2 * np.pi * t / 40.0) + 0.5 * np.sin(2 * np.pi * t / 13.0)
    scales = jt.generate_log_scales(2.0, 64.0, 48)
    res = jt.cwt(_t(x), scales, jt.MorletWavelet())
    back = jt.icwt(res).numpy()
    err = np.linalg.norm(back[200:-200] - x[200:-200]) / np.linalg.norm(
        x[200:-200])
    assert err <= 5e-2
