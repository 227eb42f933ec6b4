"""The port's decimated pyramid (``ops/fwt.py``) against the JAX package's,
on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit``.  Tolerances:

* f64, 1e-12 × max(1, max|ref|): both run the same float64 products
  (matmuls against the same host-built constants, rolls and multiply-adds)
  in another summation order;
* f32 and complex64, 1e-5 × max|ref|: the on-chip forward bound of the
  JAX package (``tools/tpu_smoke.py``), here both on the CPU;
* bf16, 5e-2 × max|ref|: both round the constants to bf16 the same way
  (checked bitwise below) and round each product's result once, in
  another order;
* the golden vectors (``tests/golden/golden.npz``), 1e-10, as
  ``tests/test_golden.py`` holds the JAX package to them;
* the host constants: exactly equal (the same float64 arithmetic);
* gradients at f64 against ``jax.grad``, 1e-9 relative.

Every case of the block-pair path has N ≥ 512, two blocks or more, so the
circular roll of the block axis is exercised (at N = 256 a wrong roll
sign is invisible).
"""
import functools
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

jfwt = importlib.import_module("jwave_pro_tpu.ops.fwt")
tfwt = importlib.import_module("jwave_pro_tpu_torch.ops.fwt")

GOLDEN = np.load(Path(__file__).resolve().parent / "golden" / "golden.npz")
GOLDEN_FWT = sorted(k for k in GOLDEN.files if k.startswith("fwt_"))
WAVELETS = ["Haar", "Haar orthogonal", "Daubechies 4", "Symlet 8",
            "Coiflet 1", "BiOrthogonal 3/5", "Discrete Meyer"]
# (wavelet, shape, level): every width path and chunking at least once —
# the fused chunk (Db4 L5 at 2048), a chunk cut by _fused_levels_limit
# (Symlet 8 L6: 4 + 2), fused chunks then single steps (default levels),
# the single-step tail below 256, Discrete Meyer's short chunks, level 0
CASES = [
    ("Daubechies 4", (2048,), 5),
    ("Daubechies 4", (2, 3, 8192), None),
    ("Daubechies 4", (2, 3, 64), None),
    ("Daubechies 4", (512,), 1),
    ("Symlet 8", (2, 3, 2048), 6),
    ("Symlet 8", (512,), None),
    ("Haar", (2, 3, 8192), None),
    ("Haar", (64,), 5),
    ("Haar orthogonal", (2, 3, 512), None),
    ("Haar orthogonal", (2048,), 5),
    ("Coiflet 1", (2, 3, 512), 5),
    ("Coiflet 1", (8192,), 1),
    ("BiOrthogonal 3/5", (2, 3, 2048), None),
    ("BiOrthogonal 3/5", (64,), 1),
    ("Discrete Meyer", (2, 3, 512), 5),
    ("Discrete Meyer", (64,), None),
    ("Daubechies 4", (2, 3, 512), 0),
]


@functools.lru_cache(maxsize=None)
def _jax(fn, *static):
    """The JAX function jitted once per static arguments (eager JAX
    compiles every op separately and is far slower)."""
    return jax.jit(lambda x: getattr(jw, fn)(x, *static))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got.astype(want.dtype) - want).max()) if want.size \
        else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} × {scale:.3g}"


@pytest.mark.parametrize("key", GOLDEN_FWT)
def test_golden_vectors(key):
    name = key[4:].replace("_", " ").replace("-", "/")
    got = jt.fwt(_t(GOLDEN["input_64"]), jt.wavelet(name))
    np.testing.assert_allclose(got.numpy(), GOLDEN[key], rtol=0, atol=1e-10)


@pytest.mark.parametrize("name,shape,level", CASES)
def test_fwt_ifwt_match_jax_f64(name, shape, level):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(CASES.index((name, shape, level))
                              ).standard_normal(shape)
    want = np.asarray(_jax("fwt", wj, level)(x))
    got = jt.fwt(_t(x), wt, level)
    assert got.dtype == torch.float64
    _close(got, want, 1e-12, "fwt")
    back_want = np.asarray(_jax("ifwt", wj, level)(want))
    back = jt.ifwt(_t(want), wt, level)
    _close(back, back_want, 1e-12, "ifwt")
    if name != "Discrete Meyer":  # its published taps are ~1e-2 PR-exact
        _close(back, x, 1e-8, "round trip")


def test_level_zero_returns_the_input():
    x = _t(np.random.default_rng(0).standard_normal((2, 64)))
    w = jt.wavelet("Daubechies 4")
    assert jt.fwt(x, w, 0) is x
    assert jt.ifwt(x, w, 0) is x


@pytest.mark.parametrize("name", ["Daubechies 4", "Haar orthogonal",
                                  "Discrete Meyer"])
@pytest.mark.parametrize("h", [512, 64, 300, 7])
def test_steps_match_jax(name, h):
    """h = 512 block pair, 64 circulant, 300 roll form; 7 the odd fold
    (synthesis only, the last element ignored)."""
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(h).standard_normal((2, 3, h))
    if h % 2 == 0:
        _close(jt.analysis_step(_t(x), wt),
               jax.jit(lambda v: jw.analysis_step(v, wj))(x), 1e-12,
               "analysis")
    _close(jt.synthesis_step(_t(x), wt),
           jax.jit(lambda v: jw.synthesis_step(v, wj))(x), 1e-12,
           "synthesis")


def test_synthesis_odd_width_ignores_the_last_element():
    w = jt.wavelet("Daubechies 4")
    x = _t(np.random.default_rng(1).standard_normal(9))
    y = x.clone()
    y[-1] = 100.0
    torch.testing.assert_close(jt.synthesis_step(x, w),
                               jt.synthesis_step(y, w), rtol=0, atol=0)


@pytest.mark.parametrize("h", [7, 9])
def test_analysis_odd_width_raises_in_both(h):
    """JAX fails in its roll form on the unequal even/odd phases (a
    broadcast ``TypeError``); the port says why, as a ``ValueError``."""
    x = np.random.default_rng(h).standard_normal(h)
    with pytest.raises(TypeError, match="broadcasting"):
        jw.analysis_step(jnp.asarray(x), jw.wavelet("Daubechies 4"))
    with pytest.raises(ValueError, match="even length"):
        jt.analysis_step(_t(x), jt.wavelet("Daubechies 4"))


def _seqs(names):
    return (tuple(jw.wavelet(n) for n in names),
            tuple(jt.wavelet(n) for n in names))


@pytest.mark.parametrize("name", WAVELETS)
def test_host_constants_equal_jax(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    f64 = "float64"
    assert tfwt._fused_levels_limit(wt) == jfwt._fused_levels_limit(wj)
    assert tfwt._fused_synth_limit(wt) == jfwt._fused_synth_limit(wj)
    np.testing.assert_array_equal(tfwt._analysis_matrix(wt),
                                  jfwt._analysis_matrix(wj, f64))
    for got, want in zip(tfwt._synthesis_matrices(wt),
                         jfwt._synthesis_matrices(wj, f64)):
        np.testing.assert_array_equal(got, want)
    for h in (8, 64, 256):
        np.testing.assert_array_equal(tfwt._analysis_matrix_small(wt, h),
                                      jfwt._analysis_matrix_small(wj, h, f64))
        np.testing.assert_array_equal(
            tfwt._synthesis_matrix_small(wt, h),
            jfwt._synthesis_matrix_small(wj, h, f64))
    for lv in range(2, max(tfwt._fused_levels_limit(wt), 2) + 1):
        np.testing.assert_array_equal(
            tfwt._analysis_matrix_fused((wt,) * lv),
            jfwt._analysis_matrix_fused((wj,) * lv, f64))
    for lv in range(2, max(tfwt._fused_synth_limit(wt), 2) + 1):
        for got, want in zip(
                tfwt._synthesis_matrices_fused((wt,) * lv),
                jfwt._synthesis_matrices_fused((wj,) * lv, f64)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(
                tfwt._synthesis_matrix_fused_packed((wt,) * lv),
                jfwt._synthesis_matrix_fused_packed((wj,) * lv, f64)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("names", [
    ("Symlet 8", "Daubechies 4", "Daubechies 4"),
    ("Symlet 8", "Daubechies 4", "Haar"),
    ("Symlet 8",) * 6,
    ("Haar orthogonal", "Daubechies 4", "Daubechies 4", "Daubechies 4"),
])
def test_mixed_sequences_equal_jax(names):
    """The dual tree's (level1, qshift, qshift, …) tuples."""
    sj, st = _seqs(names)
    assert tfwt._seq_fits_analysis(st) == jfwt._seq_fits_analysis(sj)
    assert tfwt._seq_fits_synthesis(st) == jfwt._seq_fits_synthesis(sj)
    for got, want in zip(tfwt._composite_bank(st)[1],
                         jfwt._composite_bank(sj)[1]):
        np.testing.assert_array_equal(got, want)
    if tfwt._seq_fits_synthesis(st):
        for got, want in zip(
                tfwt._synthesis_matrix_fused_packed(st),
                jfwt._synthesis_matrix_fused_packed(sj, "float64")):
            np.testing.assert_array_equal(got, want)
    if tfwt._seq_fits_analysis(st):
        np.testing.assert_array_equal(
            tfwt._analysis_matrix_fused(st),
            jfwt._analysis_matrix_fused(sj, "float64"))
        x = np.random.default_rng(3).standard_normal((3, 1024))
        lo, details = tfwt._analysis_fused_matmul(_t(x), st)
        lo_j, details_j = jfwt._analysis_fused_matmul(jnp.asarray(x), sj)
        _close(lo, lo_j, 1e-12, "lo")
        for got, want in zip(details, details_j):
            _close(got, want, 1e-12, "detail")
        back = tfwt._synthesis_fused_matmul(lo, details[::-1], st)
        _close(back, x, 1e-10, "fused round trip")


@pytest.mark.parametrize("dtype,name", [(torch.float32, "float32"),
                                        (torch.bfloat16, "bfloat16"),
                                        (torch.complex64, "complex64")])
def test_device_constants_rounded_as_jax(dtype, name):
    """The constant on the tensor's device is the host f64 one rounded to
    the tensor's dtype, as ``np.asarray(w, dtype=name)`` rounds it; it is
    cached, and it does not alias the host cache."""
    wj, wt = jw.wavelet("Symlet 8"), jt.wavelet("Symlet 8")
    like = torch.zeros(1, dtype=dtype)
    got = tfwt._const(tfwt._analysis_matrix_fused, (wt,) * 4, like=like)
    assert got.dtype == dtype
    assert tfwt._const(tfwt._analysis_matrix_fused, (wt,) * 4,
                       like=like) is got
    want = jfwt._analysis_matrix_fused((wj,) * 4, name)
    np.testing.assert_array_equal(got.to(torch.complex128).numpy(),
                                  want.astype(np.complex128))
    f64 = tfwt._const(tfwt._analysis_matrix_fused, (wt,) * 4,
                      like=torch.zeros(1, dtype=torch.float64))
    assert not np.shares_memory(
        f64.numpy(), tfwt._analysis_matrix_fused((wt,) * 4))


def test_fwt2_ifwt2_match_jax():
    wj, wt = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
    x = np.random.default_rng(5).standard_normal((2, 64, 512))
    for lr, lc in ((3, 7), (None, None)):
        want = np.asarray(_jax("fwt2", wj, lr, lc)(x))
        got = jt.fwt2(_t(x), wt, lr, lc)
        _close(got, want, 1e-12, "fwt2")
        back = jt.ifwt2(_t(want), wt, lr, lc)
        _close(back, _jax("ifwt2", wj, lr, lc)(want), 1e-12, "ifwt2")
        _close(back, x, 1e-8, "2D round trip")


def test_fwt3_ifwt3_match_jax():
    wj, wt = jw.wavelet("Symlet 8"), jt.wavelet("Symlet 8")
    x = np.random.default_rng(6).standard_normal((2, 16, 32, 64))
    levels = (2, 3, 4)
    want = np.asarray(_jax("fwt3", wj, levels)(x))
    got = jt.fwt3(_t(x), wt, levels)
    _close(got, want, 1e-12, "fwt3")
    back = jt.ifwt3(_t(want), wt, levels)
    _close(back, _jax("ifwt3", wj, levels)(want), 1e-12, "ifwt3")
    _close(back, x, 1e-8, "3D round trip")


@pytest.mark.parametrize("name", ["Daubechies 4", "Haar orthogonal"])
def test_decompose_recompose_match_jax(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(7).standard_normal((2, 512))
    want = np.asarray(_jax("decompose", wj)(x))
    got = jt.decompose(_t(x), wt)
    assert got.shape == (10, 2, 512)
    _close(got, want, 1e-12, "decompose")
    for level in (0, 4, 9):
        _close(jt.recompose(got, wt, level),
               jw.recompose(jnp.asarray(want), wj, level), 1e-12,
               f"recompose {level}")


def _twl8():
    """A wavelet whose transform_wavelength (8) stops the pyramid early."""
    taps = jw.wavelet("Daubechies 4").dec_lo
    return (jw.qmf_orthonormal("TWL8", taps, transform_wavelength=8),
            jt.qmf_orthonormal("TWL8", taps, transform_wavelength=8))


def test_transform_wavelength_stops_the_pyramid():
    wj, wt = _twl8()
    x = np.random.default_rng(8).standard_normal((2, 512))
    want = np.asarray(_jax("fwt", wj, None)(x))
    got = jt.fwt(_t(x), wt)
    _close(got, want, 1e-12, "fwt")
    # the last 8 samples are the width-8 step's output, never split further
    full = jt.fwt(_t(x), jt.wavelet("Daubechies 4"))
    assert not torch.allclose(got[..., :4], full[..., :4])
    _close(jt.ifwt(got, wt), _jax("ifwt", wj, None)(want), 1e-12, "ifwt")
    _close(jt.ifwt(got, wt), x, 1e-8, "round trip")
    _close(jt.decompose(_t(x), wt), _jax("decompose", wj)(x), 1e-12,
           "decompose")


def test_float32_and_complex64_match_jax():
    wj, wt = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    want = np.asarray(_jax("fwt", wj, None)(x))
    got = jt.fwt(_t(x), wt)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close(got, want, 1e-5, "f32 fwt")
    _close(jt.ifwt(got, wt), x, 1e-5, "f32 round trip")
    z = (rng.standard_normal((2, 1024))
         + 1j * rng.standard_normal((2, 1024))).astype(np.complex64)
    want = np.asarray(_jax("fwt", wj, 5)(z))
    got = jt.fwt(_t(z), wt, 5)
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    _close(got, want, 1e-5, "complex64 fwt")
    _close(jt.ifwt(got, wt, 5), z, 1e-5, "complex64 round trip")


def test_bfloat16_matches_jax():
    wj, wt = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
    x = np.random.default_rng(10).standard_normal((2, 2048)).astype(
        np.float32)
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    want = np.asarray(_jax("fwt", wj, 5)(xb).astype(jnp.float32))
    got = jt.fwt(_t(x).to(torch.bfloat16), wt, 5)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, 5e-2, "bf16 fwt")
    back = jt.ifwt(got, wt, 5)
    assert back.dtype == torch.bfloat16
    _close(back.float(), _jax("ifwt", wj, 5)(jnp.asarray(
        got.float().numpy(), dtype=jnp.bfloat16)).astype(jnp.float32),
        5e-2, "bf16 ifwt")


def test_integer_input_gives_the_float_transform():
    """JAX casts its constants to the input dtype, so int input gives int
    zeros (a reference fault); the port transforms the values in torch's
    default float dtype."""
    wj, wt = jw.daubechies(4), jt.daubechies(4)
    x = np.arange(512) % 7
    ref = np.asarray(jw.fwt(x, wj, 1))
    assert np.issubdtype(ref.dtype, np.integer) and not ref.any()
    got = jt.fwt(torch.from_numpy(x), wt, 1)
    assert got.dtype == torch.get_default_dtype()
    want = jt.fwt(torch.from_numpy(x).to(got.dtype), wt, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    _close(got, _jax("fwt", wj, 1)(x.astype(np.float32)), 1e-5, "vs JAX f32")
    assert float(got[0]) == pytest.approx(6.865, abs=1e-3)


@pytest.mark.parametrize("fn", ["fwt", "ifwt", "decompose"])
def test_errors_match_jax(fn):
    wj, wt = jw.wavelet("Haar"), jt.wavelet("Haar")
    args = () if fn == "decompose" else (None,)
    with pytest.raises(jw.exceptions.NotValid) as jax_err:
        getattr(jw, fn)(jnp.zeros(100), wj, *args)
    with pytest.raises(jt.NotValid) as port_err:
        getattr(jt, fn)(torch.zeros(100), wt, *args)
    assert str(port_err.value) == str(jax_err.value)
    if fn != "decompose":
        for level in (-1, 7):
            with pytest.raises(ValueError) as jax_err:
                getattr(jw, fn)(jnp.zeros(64), wj, level)
            with pytest.raises(ValueError) as port_err:
                getattr(jt, fn)(torch.zeros(64), wt, level)
            assert str(port_err.value) == str(jax_err.value)


def test_exception_hierarchy_matches_jax():
    from jwave_pro_tpu import exceptions as je

    for name in je.__all__:
        port, ref = getattr(jt, name), getattr(je, name)
        assert [c.__name__ for c in port.__mro__] == \
            [c.__name__ for c in ref.__mro__], name


def test_validation_helpers_match_jax():
    from jwave_pro_tpu.utils import validation as jv

    for n in (1, 2, 3, 42, 64, 100, 1 << 20):
        assert jt.is_power_of_two(n) == jv.is_power_of_two(n)
        assert jt.ancient_egyptian_decomposition(n) == \
            jv.ancient_egyptian_decomposition(n)
        assert jt.utils.exponent(n) == jv.exponent(n)
        if jv.is_power_of_two(n):
            for twl in (2, 8):
                assert jt.max_level(n, twl) == jv.max_level(n, twl)
            jt.utils.check_power_of_two(n)
        else:
            with pytest.raises(jt.NotValid):
                jt.max_level(n)


@pytest.mark.parametrize("inverse", [False, True])
def test_gradients_match_jax(inverse):
    """Through the fused chunks, the single steps and the circulant tail."""
    wj, wt = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
    rng = np.random.default_rng(11 + inverse)
    x = rng.standard_normal((2, 2048))
    wts = rng.standard_normal((2, 2048))
    fn = "ifwt" if inverse else "fwt"
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(getattr(jw, fn)(v, wj) * wts)))(x))
    xt = _t(x).requires_grad_()
    (getattr(jt, fn)(xt, wt) * _t(wts)).sum().backward()
    err = float(np.abs(xt.grad.numpy() - want).max())
    assert err <= 1e-9 * float(np.abs(want).max())


@pytest.mark.parametrize("setting", ["matmul precision", "per backend"])
def test_f32_pin_restores_the_process_setting(setting):
    """``_f32_products()`` sets IEEE f32 products for its block, with
    torch's two settings in agreement, and restores the TF32 the process
    had, set through either of them."""
    mm = torch.backends.cuda.matmul
    if setting == "per backend" and not hasattr(mm, "fp32_precision"):
        pytest.skip("torch without the per-backend fp32_precision setting")
    prev = torch.get_float32_matmul_precision()
    try:
        if setting == "per backend":
            mm.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision("high")
        with tfwt._f32_products():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not mm.allow_tf32
        if setting == "per backend":
            assert mm.fp32_precision == "tf32"
        else:
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("setting", ["matmul precision", "per backend"])
def test_tf32_tier_sets_and_restores_the_process_setting(setting):
    """``_f32_products(tf32=True)`` (the banded CWT's 'high' tier) sets TF32
    products for its block through the setting the caller used, and
    restores the IEEE float32 the process had."""
    mm = torch.backends.cuda.matmul
    if setting == "per backend" and not hasattr(mm, "fp32_precision"):
        pytest.skip("torch without the per-backend fp32_precision setting")
    prev = torch.get_float32_matmul_precision()
    try:
        if setting == "per backend":
            mm.fp32_precision = "ieee"
        else:
            torch.set_float32_matmul_precision("highest")
        with tfwt._f32_products(tf32=True):
            if setting == "per backend":
                assert mm.fp32_precision == "tf32"
            else:
                assert torch.get_float32_matmul_precision() == "high"
        if setting == "per backend":
            assert mm.fp32_precision == "ieee"
        else:
            assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(prev)
