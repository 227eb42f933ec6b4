"""The port's wavelet packet tree, best basis and packet denoisers
(``ops/wpt.py``, ``ops/denoise.py``) against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit`` where they take array arguments only.  Tolerances:

* f64, 1e-12 × max(1, max|ref|): the same float64 products against the
  same host-built constants, in another summation order;
* f32, 1e-5 × max|ref|; bf16, 5e-2 × max|ref| (as ``test_torch_fwt.py``);
* the golden vectors (``tests/golden/golden.npz``), 1e-10, as
  ``tests/test_golden.py`` holds the JAX package to them;
* best-basis masks exactly equal (both run the strict ``children <
  parent`` DP bottom up on costs that agree to ~1e-13);
* the host constants exactly equal.
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

jwpt = importlib.import_module("jwave_pro_tpu.ops.wpt")
twpt = importlib.import_module("jwave_pro_tpu_torch.ops.wpt")

GOLDEN = np.load(Path(__file__).resolve().parent / "golden" / "golden.npz")
GOLDEN_WPT = sorted(k for k in GOLDEN.files if k.startswith("wpt_"))
COSTS = ["shannon", "logenergy", "threshold", "sure"]
# (wavelet, shape, level): levels 1–6, fused chunks of the whole tree
# (Db4 L5, Symlet 8 cut at 4 + 2), single steps, the energy correction
CASES = [
    ("Daubechies 4", (2, 3, 2048), 5),
    ("Daubechies 4", (64,), 1),
    ("Symlet 8", (65536,), 6),
    ("Symlet 8", (2, 512), 3),
    ("Haar", (2, 3, 1024), None),
    ("Haar orthogonal", (2, 512), 4),
    ("Coiflet 1", (256,), 2),
    ("BiOrthogonal 3/5", (2, 1024), 6),
]


@functools.lru_cache(maxsize=None)
def _jax(fn, *static, **options):
    """The JAX function jitted once per static arguments; its array
    arguments come first (eager JAX compiles every op separately)."""
    n = {"basis_reconstruct": 2, "basis_reconstruct2": 2,
         "basis_coefficients": 2, "basis_coefficients2": 2}.get(fn, 1)
    if fn.endswith("_denoise"):
        return jax.jit(lambda x, t: getattr(jw, fn)(x, *static, threshold=t,
                                                    **options))
    return jax.jit(lambda *a: getattr(jw, fn)(*a[:n], *static, *a[n:],
                                              **options))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(want.dtype) - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} × {scale:.3g}"


def _masks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("key", GOLDEN_WPT)
def test_golden_vectors(key):
    name = key[4:].replace("_", " ").replace("-", "/")
    got = jt.wpt(_t(GOLDEN["input_64"]), jt.wavelet(name), 3)
    np.testing.assert_allclose(got.numpy(), GOLDEN[key], rtol=0, atol=1e-10)


@pytest.mark.parametrize("name,shape,level", CASES)
def test_wpt_iwpt_match_jax_f64(name, shape, level):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(CASES.index((name, shape, level))
                              ).standard_normal(shape)
    want = np.asarray(_jax("wpt", wj, level)(x))
    got = jt.wpt(_t(x), wt, level)
    _close(got, want, 1e-12, "wpt")
    back = jt.iwpt(_t(want), wt, level)
    _close(back, _jax("iwpt", wj, level)(want), 1e-12, "iwpt")
    _close(back, x, 1e-8, "round trip")


@pytest.mark.parametrize("name", ["Daubechies 4", "Symlet 8",
                                  "Haar orthogonal"])
def test_wpt_tree_matches_jax_and_the_fused_path(name):
    """Row l of the tree (single steps) equals the fused wpt at level l."""
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(1).standard_normal((2, 2048))
    want = np.asarray(_jax("wpt_tree", wj, 6)(x))
    got = jt.wpt_tree(_t(x), wt, 6)
    assert got.shape == (7, 2, 2048)
    _close(got, want, 1e-12, "wpt_tree")
    _close(jt.wpt(_t(x), wt, 6), got[6], 1e-12, "fused vs stepwise")


@pytest.mark.parametrize("name", ["Daubechies 4", "Symlet 8", "Haar",
                                  "Haar orthogonal", "BiOrthogonal 3/5"])
def test_host_constants_equal_jax(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    for lv in range(2, twpt._fused_levels_limit(wt) + 1):
        np.testing.assert_array_equal(
            twpt._wpt_analysis_matrix_fused(wt, lv),
            jwpt._wpt_analysis_matrix_fused(wj, lv, "float64"))
    for lv in range(2, twpt._fused_synth_limit(wt) + 1):
        np.testing.assert_array_equal(
            twpt._wpt_synthesis_matrix_fused(wt, lv),
            jwpt._wpt_synthesis_matrix_fused(wj, lv, "float64"))
    assert twpt._level_widths(1024, 6, 2) == jwpt._level_widths(1024, 6, 2)


def test_wpt2_iwpt2_wpt3_iwpt3_match_jax():
    wj, wt = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 512))
    want = np.asarray(_jax("wpt2", wj, 3, 5)(x))
    _close(jt.wpt2(_t(x), wt, 3, 5), want, 1e-12, "wpt2")
    back = jt.iwpt2(_t(want), wt, 3, 5)
    _close(back, _jax("iwpt2", wj, 3, 5)(want), 1e-12, "iwpt2")
    _close(back, x, 1e-8, "2D round trip")
    v = rng.standard_normal((2, 16, 32, 64))
    levels = (2, 3, 4)
    want = np.asarray(_jax("wpt3", wj, levels)(v))
    _close(jt.wpt3(_t(v), wt, levels), want, 1e-12, "wpt3")
    back = jt.iwpt3(_t(want), wt, levels)
    _close(back, _jax("iwpt3", wj, levels)(want), 1e-12, "iwpt3")
    _close(back, v, 1e-8, "3D round trip")


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("cost", COSTS)
def test_best_basis_matches_jax(cost, per_sample):
    wj, wt = jw.wavelet("Symlet 8"), jt.wavelet("Symlet 8")
    rng = np.random.default_rng(COSTS.index(cost))
    t = np.arange(512) / 512.0
    # tonal rows, so the bases differ between samples and from the root
    x = (np.sin(2 * np.pi * np.array([[40.0], [90.0], [7.0]]) * t)
         + 0.3 * rng.standard_normal((3, 512)))
    masks, cost_j, tree = _jax("best_basis", wj, 5, cost,
                               per_sample=per_sample)(x)
    got_m, got_c, got_t = jt.best_basis(_t(x), wt, 5, cost,
                                        per_sample=per_sample)
    _masks_equal(got_m, masks)
    assert got_m[2].shape == ((3, 4) if per_sample else (4,))
    _close(got_c, cost_j, 1e-12, "total cost")
    _close(got_t, tree, 1e-12, "tree")
    flat = jt.basis_coefficients(got_t, got_m)
    _close(flat, _jax("basis_coefficients")(tree, masks), 1e-12,
           "coefficients")
    back = jt.basis_reconstruct(flat, got_m, wt)
    _close(back, _jax("basis_reconstruct", wj)(flat.numpy(), masks), 1e-12,
           "reconstruct")
    _close(back, x, 1e-8, "round trip")


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("cost", COSTS)
def test_best_basis2_matches_jax(cost, per_sample):
    wj, wt = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
    rng = np.random.default_rng(10 + COSTS.index(cost))
    r = np.arange(32)[:, None] / 32.0
    c = np.arange(64)[None, :] / 64.0
    x = (np.stack([np.sin(2 * np.pi * (5 * r + 11 * c)),
                   np.cos(2 * np.pi * 13 * c) + 0 * r])
         + 0.3 * rng.standard_normal((2, 32, 64)))
    masks, cost_j, tree = _jax("best_basis2", wj, 3, cost,
                               per_sample=per_sample)(x)
    got_m, got_c, got_t = jt.best_basis2(_t(x), wt, 3, cost,
                                         per_sample=per_sample)
    _masks_equal(got_m, masks)
    _close(got_c, cost_j, 1e-12, "total cost")
    _close(got_t, tree, 1e-12, "tree")
    flat = jt.basis_coefficients2(got_t, got_m)
    _close(flat, _jax("basis_coefficients2")(tree, masks), 1e-12,
           "coefficients")
    back = jt.basis_reconstruct2(flat, got_m, wt)
    _close(back, _jax("basis_reconstruct2", wj)(flat.numpy(), masks), 1e-12,
           "reconstruct")
    _close(back, x, 1e-8, "round trip")


def test_masks_as_numpy_arrays_are_accepted():
    w = jt.wavelet("Daubechies 4")
    x = _t(np.random.default_rng(3).standard_normal((2, 256)))
    masks, _, tree = jt.best_basis(x, w, 4)
    flat = jt.basis_coefficients(tree, [m.numpy() for m in masks])
    torch.testing.assert_close(flat, jt.basis_coefficients(tree, masks))
    torch.testing.assert_close(
        jt.basis_reconstruct(flat, [m.numpy() for m in masks], w), x)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_wpt_denoise_matches_jax(mode, per_sample):
    wj, wt = jw.wavelet("Symlet 8"), jt.wavelet("Symlet 8")
    rng = np.random.default_rng(4)
    t = np.arange(1024) / 1024.0
    x = (np.sin(2 * np.pi * np.array([[60.0], [200.0]]) * t)
         + 0.5 * rng.standard_normal((2, 1024)))
    for threshold in (None, np.array([[0.4], [0.9]])):
        want = _jax("wpt_denoise", wj, 5, mode=mode,
                    per_sample=per_sample)(x, threshold)
        got = jt.wpt_denoise(_t(x), wt, 5, mode=mode, threshold=threshold,
                             per_sample=per_sample)
        _close(got, want, 1e-12, f"threshold {threshold is not None}")


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_wpt2_denoise_matches_jax(mode, per_sample):
    wj, wt = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
    rng = np.random.default_rng(5)
    c = np.arange(64)[None, :] / 64.0
    x = (np.stack([np.sin(2 * np.pi * 9 * c) + 0 * c.T[:32],
                   np.cos(2 * np.pi * 3 * c) + 0 * c.T[:32]])
         + 0.5 * rng.standard_normal((2, 32, 64)))
    for threshold in (None, np.array([[[0.3]], [[0.8]]])):
        want = _jax("wpt2_denoise", wj, 3, mode=mode,
                    per_sample=per_sample)(x, threshold)
        got = jt.wpt2_denoise(_t(x), wt, 3, mode=mode, threshold=threshold,
                              per_sample=per_sample)
        _close(got, want, 1e-12, f"threshold {threshold is not None}")


def test_transform_wavelength_stops_the_tree():
    taps = jw.wavelet("Daubechies 4").dec_lo
    wj = jw.qmf_orthonormal("TWL8", taps, transform_wavelength=8)
    wt = jt.qmf_orthonormal("TWL8", taps, transform_wavelength=8)
    x = np.random.default_rng(6).standard_normal((2, 64))
    want = np.asarray(_jax("wpt", wj, None)(x))
    got = jt.wpt(_t(x), wt)
    _close(got, want, 1e-12, "wpt")
    _close(jt.iwpt(got, wt), x, 1e-8, "round trip")
    # the tree stops at width 8: levels 4 and 6 are the same
    _close(jt.wpt(_t(x), wt, 4), got.numpy(), 0, "level 4 = default")


def test_float32_bfloat16_and_integer_input():
    wj, wt = jw.wavelet("Symlet 8"), jt.wavelet("Symlet 8")
    x = np.random.default_rng(7).standard_normal((2, 4096)).astype(
        np.float32)
    want = np.asarray(_jax("wpt", wj, 6)(x))
    got = jt.wpt(_t(x), wt, 6)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5, "f32 wpt")
    _close(jt.iwpt(got, wt, 6), x, 1e-5, "f32 round trip")
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    got = jt.wpt(_t(x).to(torch.bfloat16), wt, 6)
    assert got.dtype == torch.bfloat16
    _close(got.float(), _jax("wpt", wj, 6)(xb).astype(jnp.float32), 5e-2,
           "bf16 wpt")
    # JAX gives int zeros (its constants cast to the input dtype); the port
    # transforms the values in torch's default float dtype
    xi = np.arange(1024) % 7
    ref = np.asarray(jw.wpt(xi, wj, 2))
    assert np.issubdtype(ref.dtype, np.integer) and not ref.any()
    got = jt.wpt(torch.from_numpy(xi), wt, 2)
    assert got.dtype == torch.get_default_dtype()
    torch.testing.assert_close(
        got, jt.wpt(torch.from_numpy(xi).to(got.dtype), wt, 2),
        rtol=0, atol=0)


def test_errors_match_jax():
    wj, wt = jw.wavelet("Haar"), jt.wavelet("Haar")
    for fn in ("wpt", "iwpt", "wpt_tree"):
        with pytest.raises(jw.exceptions.NotValid) as jax_err:
            getattr(jw, fn)(jnp.zeros(96), wj)
        with pytest.raises(jt.NotValid) as port_err:
            getattr(jt, fn)(torch.zeros(96), wt)
        assert str(port_err.value) == str(jax_err.value)
    x = np.zeros((16, 32))
    for level in (0, 5):
        with pytest.raises(ValueError) as jax_err:
            jw.best_basis2(x, wj, level)
        with pytest.raises(ValueError) as port_err:
            jt.best_basis2(_t(x), wt, level)
        assert str(port_err.value) == str(jax_err.value)
