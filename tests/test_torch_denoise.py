"""The port's 1D denoise against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 thresholds and the 'auto' pipeline, 1e-12 absolute: the same float64
  arithmetic in both; hard thresholding is discontinuous, but the inputs
  are random, so no coefficient sits within rounding of a threshold.
* ``method='fused'``, f32, 2e-5 absolute: the port's plain version of the
  fused kernel against the JAX Pallas kernel in interpret mode, the bound
  ``tests/test_pallas_kernels.py`` holds the Pallas kernel to.
"""
import functools

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.denoise_pallas import (
    modwt_denoise_fused as jax_denoise_fused,
)
from jwave_pro_tpu_torch.kernels import denoise_cuda as kd

DB4 = "Daubechies 4"


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_denoise(*static):
    return jax.jit(lambda x: jw.modwt_denoise(x, *static))


def _denoise_both(x, level, mode, method, threshold):
    want = np.asarray(_jax_denoise(jw.wavelet(DB4), level, mode, method,
                                   threshold)(x))
    got = jt.modwt_denoise(_t(x), jt.wavelet(DB4), level, mode=mode,
                           method=method, threshold=threshold)
    return got, want


def test_soft_hard_threshold_match_jax():
    c = np.random.default_rng(0).standard_normal((3, 50))
    t = np.array([[0.2], [0.5], [1.0]])
    np.testing.assert_array_equal(jt.soft_threshold(_t(c), _t(t)).numpy(),
                                  np.asarray(jw.soft_threshold(c, t)))
    np.testing.assert_array_equal(jt.hard_threshold(_t(c), 0.5).numpy(),
                                  np.asarray(jw.hard_threshold(c, 0.5)))


@pytest.mark.parametrize("n", [1000, 1001])
def test_mad_sigma_median_is_midpoint_like_jnp(n):
    """An even count takes the mean of the two middle values (jnp.median),
    not torch.median's lower middle value."""
    d = np.random.default_rng(n).standard_normal((2, n))
    got = jt.mad_sigma(_t(d)).numpy()
    np.testing.assert_allclose(got, np.asarray(jw.mad_sigma(d)), rtol=0,
                               atol=1e-15)
    lower = torch.median(torch.abs(_t(d)), dim=-1).values.numpy() / 0.6745
    assert (not np.allclose(got, lower)) if n % 2 == 0 else \
        np.allclose(got, lower)


def test_universal_threshold_matches_jax():
    d = np.random.default_rng(1).standard_normal((4, 512))
    np.testing.assert_allclose(
        jt.universal_threshold(_t(d)).numpy(),
        np.asarray(jw.universal_threshold(d)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["dense", "sparse", "batched"])
def test_sure_threshold_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "dense":     # energy above the sparsity bound: SURE branch
        y, sigma = rng.normal(size=512) + rng.normal(scale=3.0, size=512), 1.0
    elif case == "sparse":  # pure noise: universal fallback
        y, sigma = rng.normal(size=1024), 1.3
    else:
        y = rng.normal(size=(3, 256)) * np.array([[1.0], [2.0], [5.0]])
        sigma = None
    got = jt.sure_threshold(_t(y), sigma=sigma).numpy()
    want = np.asarray(jw.sure_threshold(y, sigma=sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("signal_scale", [2.0, 0.5])
def test_bayes_threshold_matches_jax(signal_scale):
    rng = np.random.default_rng(4)
    d = rng.normal(scale=1.0, size=(2, 4096)) \
        + rng.normal(scale=signal_scale, size=(2, 4096))
    sigma = 1.3
    np.testing.assert_allclose(jt.bayes_threshold(_t(d), sigma).numpy(),
                               np.asarray(jw.bayes_threshold(d, sigma)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("axis", [0, -1, None])
def test_mad_sigma_axis_matches_jax(axis):
    """``axis`` as the reference names it; None reduces every element."""
    d = np.random.default_rng(20).standard_normal((6, 40))
    got = jt.mad_sigma(_t(d), axis=axis)
    want = np.asarray(jw.mad_sigma(d, axis=axis))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("rule", ["universal", "sure", "bayes"])
def test_threshold_estimators_take_axis_like_jax(rule, axis):
    d = np.random.default_rng(21).standard_normal((64, 48)) * 1.5
    if rule == "universal":
        got = jt.universal_threshold(_t(d), axis=axis)
        want = jw.universal_threshold(d, axis=axis)
    elif rule == "sure":
        got = jt.sure_threshold(_t(d), axis=axis)
        want = jw.sure_threshold(d, axis=axis)
    else:
        got = jt.bayes_threshold(_t(d), 1.3, axis=axis)
        want = jw.bayes_threshold(d, 1.3, axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("axis", [(0, 2), (-1, 0), (1,)])
def test_mad_sigma_tuple_axis_matches_jax(axis, nan):
    """A tuple ``axis`` reduces over all its axes, as ``jnp.median`` does;
    a NaN anywhere in them gives NaN."""
    d = np.random.default_rng(23).standard_normal((3, 4, 50))
    if nan:
        d[1, 2, 7] = np.nan
    got = jt.mad_sigma(_t(d), axis=axis).numpy()
    want = np.asarray(jw.mad_sigma(d, axis=axis))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_universal_threshold_tuple_axis_with_n_matches_jax():
    d = np.random.default_rng(24).standard_normal((3, 4, 50))
    got = jt.universal_threshold(_t(d), n=9, axis=(0, 2)).numpy()
    want = np.asarray(jw.universal_threshold(d, n=9, axis=(0, 2)))
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("rule", ["universal", "sure"])
def test_tuple_axis_without_n_raises_in_both(rule):
    """Both packages read ``d.shape[axis]`` here, so a tuple raises in
    both: ``universal_threshold`` without ``n``, and ``sure_threshold``."""
    d = np.random.default_rng(25).standard_normal((3, 4, 50))
    fj, ft = {"universal": (jw.universal_threshold, jt.universal_threshold),
              "sure": (jw.sure_threshold, jt.sure_threshold)}[rule]
    with pytest.raises(TypeError):
        fj(d, axis=(0, 2))
    with pytest.raises(TypeError):
        ft(_t(d), axis=(0, 2))


@pytest.mark.parametrize("axis", [-1, 0, None])
def test_mad_sigma_propagates_nan_like_jax(axis):
    """A NaN in the reduced axis gives NaN (``torch.sort`` puts it last, and
    the median of the rest would be finite)."""
    d = np.random.default_rng(22).standard_normal((4, 128))
    d[1, 17] = np.nan
    got = jt.mad_sigma(_t(d), axis=axis).numpy()
    want = np.asarray(jw.mad_sigma(d, axis=axis))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def _median_case(case: str) -> np.ndarray:
    """float32 rows for the median's plain version against the sort."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("gauss"):
        return rng.standard_normal((4, int(case[5:]))).astype(np.float32)
    if case == "equal":
        return np.full((3, 64), -1.5, np.float32)
    if case == "ties":                # long tie runs across the middle
        return rng.integers(-2, 3, (4, 1000)).astype(np.float32)
    if case == "tie_run":             # one value holds the middle third
        x = np.repeat(np.float32([0.1, 0.5, 0.9]), [333, 334, 333])
        return np.stack([rng.permutation(x) for _ in range(3)])
    if case.startswith("split"):      # even n: the middles in two buckets
        lo, hi = {"split_first": (1e-30, 1e30),         # of the first digit
                  "split_second": (1.0, 1.0 + 2 ** -12),  # of the second
                  "split_last": (1.0, 1.0 + 2 ** -23)}[case]  # of the last
        x = np.repeat(np.float32([lo, hi]), 500)
        return np.stack([rng.permutation(x) for _ in range(3)])
    if case == "special":             # zeros, ±inf, denormals
        x = rng.standard_normal((4, 999)).astype(np.float32)
        x[0, ::2] = np.inf
        x[1, 1::2] = -np.inf
        x[2] = rng.standard_normal(999) * np.float32(1e-41)
        x[3, ::3] = 0.0
        return x
    x = rng.standard_normal((4, 1000)).astype(np.float32)      # "nan"
    x[1, 17] = x[3, 999] = np.nan
    return x


MEDIAN_CASES = ["gauss1", "gauss2", "gauss3", "gauss1001", "gauss1000",
                "equal", "ties", "tie_run", "split_first", "split_second",
                "split_last", "special", "nan"]


@pytest.mark.parametrize("absolute", [True, False])
@pytest.mark.parametrize("case", MEDIAN_CASES)
def test_median_plain_equals_the_sort_bitwise(case, absolute):
    """The median kernel's plain version (the CPU's float32 median) is the
    sort path's result bit for bit: n = 1, 2, odd and even, equal rows,
    tie runs across the middle, middles split at each of the three
    digits, zeros, infinities, denormals and NaN rows, over |x| and x.  On
    signed input a zero may stand for either zero (order keys put −0 below
    +0, where the sort treats them as equal)."""
    from jwave_pro_tpu_torch.kernels import median_cuda as km
    from jwave_pro_tpu_torch.ops import denoise as dn

    x = _t(_median_case(case))
    got = km.median_plain(x, absolute)
    want = dn._sort_median(x.abs() if absolute else x, -1)
    same = got.view(torch.int32) == want.view(torch.int32)
    if not absolute:
        same |= (got == 0) & (want == 0)
    assert bool(same.all()), (got, want)
    if case == "nan":
        assert torch.isnan(got).tolist() == [False, True, False, True]


@pytest.mark.parametrize("axis", [-1, 0, None, (0, 2)])
def test_f32_mad_sigma_and_universal_threshold_match_jax(axis):
    """Float32 input takes the radix select (the plain version on the
    CPU); σ and the universal threshold stay the JAX package's."""
    d = np.random.default_rng(26).standard_normal((3, 40, 50)).astype(
        np.float32)
    got = jt.mad_sigma(_t(d), axis=axis)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jw.mad_sigma(
        d, axis=axis)), rtol=2e-7, atol=0)
    if not isinstance(axis, tuple):
        np.testing.assert_allclose(
            jt.universal_threshold(_t(d), axis=axis or -1).numpy(),
            np.asarray(jw.universal_threshold(d, axis=axis or -1)),
            rtol=4e-7, atol=0)


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_modwt_denoise_nan_outputs_match_jax(mode):
    """One NaN in a (2, 128) Db4 L3 f64 signal: as many NaN outputs as JAX
    (its row's default threshold is NaN)."""
    x = np.random.default_rng(23).standard_normal((2, 128))
    x[0, 40] = np.nan
    got, want = _denoise_both(x, 3, mode, "auto", None)
    assert int(torch.isnan(got).sum()) == int(np.isnan(want).sum()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_modwt2_denoise_nan_outputs_match_jax():
    x = np.random.default_rng(24).standard_normal((2, 24, 40))
    x[1, 5, 7] = np.nan
    w = jw.wavelet(DB4)
    want = np.asarray(jax.jit(lambda a: jw.modwt2_denoise(a, w, 2))(x))
    got = jt.modwt2_denoise(_t(x), jt.wavelet(DB4), 2)
    assert int(torch.isnan(got).sum()) == int(np.isnan(want).sum()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_ndarray_threshold_matches_jax(mode):
    """A NumPy threshold becomes a tensor in the coefficients' dtype and on
    their device, in both shrink functions and the 1D pipeline."""
    rng = np.random.default_rng(25)
    c = rng.standard_normal((3, 50))
    t = np.array([[0.2], [0.5], [1.0]])
    jt_fn, jw_fn = ((jt.soft_threshold, jw.soft_threshold) if mode == "soft"
                    else (jt.hard_threshold, jw.hard_threshold))
    np.testing.assert_array_equal(jt_fn(_t(c), t).numpy(),
                                  np.asarray(jw_fn(c, t)))
    np.testing.assert_array_equal(jt_fn(_t(c), [[0.5]]).numpy(),
                                  np.asarray(jw_fn(c, 0.5)))
    x = rng.standard_normal((2, 512))
    thr = np.array([[0.6], [0.9]])
    w = jw.wavelet(DB4)
    want = np.asarray(jax.jit(lambda a, t: jw.modwt_denoise(
        a, w, 3, mode, "auto", t))(x, thr))
    got = jt.modwt_denoise(_t(x), jt.wavelet(DB4), 3, mode=mode,
                           threshold=thr)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    c32 = _t(c.astype(np.float32))
    assert jt_fn(c32, t).dtype == torch.float32


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("rule", [None, "universal", "sure", "bayes", 0.7])
def test_modwt_denoise_auto_matches_jax_f64(rule, mode):
    x = np.random.default_rng(6).standard_normal((2, 1000))   # even N
    got, want = _denoise_both(x, 4, mode, "auto", rule)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rule,mode", [
    (None, "soft"), ("sure", "soft"), ("bayes", "soft"), (None, "hard"),
    (0.8, "soft"),
])
def test_modwt_denoise_fused_matches_jax(rule, mode):
    x = np.random.default_rng(8).standard_normal((2, 4096)).astype(
        np.float32)
    got, want = _denoise_both(x, 3, mode, "fused", rule)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_fused_plain_matches_jax_kernel_per_row_arbitrary_n():
    """Per-row thresholds at an arbitrary N, straight to both kernels."""
    x = np.random.default_rng(9).standard_normal((8, 2000)).astype(
        np.float32)
    thr = np.linspace(0.1, 2.0, 8).astype(np.float32)
    want = np.asarray(jax_denoise_fused(jnp.asarray(x), jnp.asarray(thr),
                                        jw.wavelet(DB4), 3, interpret=True))
    got = kd.modwt_denoise_fused(_t(x), _t(thr), jt.wavelet(DB4), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_fused_1d_input():
    x = np.random.default_rng(10).standard_normal(4096).astype(np.float32)
    got = jt.modwt_denoise(_t(x), jt.wavelet(DB4), 3, method="fused",
                           threshold=0.8)
    want = jt.modwt_denoise(_t(x)[None], jt.wavelet(DB4), 3, method="fused",
                            threshold=0.8)[0]
    assert got.shape == (4096,)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_plain_bf16_rounds_once():
    """bf16 in and out, the whole chain in f32: equals the f32 result
    rounded to bf16 once."""
    x = _t(np.random.default_rng(12).standard_normal((4, 1024)).astype(
        np.float32)).bfloat16()
    thr = torch.full((4,), 0.8)
    w = jt.wavelet(DB4)
    got = kd.modwt_denoise_plain(x, thr, w, 3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kd.modwt_denoise_plain(x.float(), thr, w,
                                                   3).bfloat16())


def test_fused_raises_on_unsupported_shape():
    # Db4 L9: the two-sided window's (L+2) rows exceed a block's 227 KB
    with pytest.raises(ValueError, match="unsupported shape"):
        jt.modwt_denoise(torch.zeros(2, 4096), jt.wavelet(DB4), 9,
                         method="fused", threshold=0.5)
    with pytest.raises(ValueError):
        jt.modwt_denoise(torch.zeros(2, 2, 64), jt.wavelet(DB4), 2,
                         method="fused")


def test_unknown_rule_raises_like_jax():
    x = np.ones(256)
    for method in ("auto", "fused"):
        with pytest.raises(ValueError, match="unknown threshold rule"):
            jt.modwt_denoise(_t(x), jt.wavelet(DB4), 3, method=method,
                             threshold="nope")
    with pytest.raises(ValueError, match="unknown threshold rule"):
        jw.modwt_denoise(x, jw.wavelet(DB4), 3, threshold="nope")


def test_modwt_denoise_inplace_writes_into_x():
    x = _t(np.random.default_rng(13).standard_normal((2, 1024)))
    want = jt.modwt_denoise(x, jt.wavelet(DB4), 4)
    ptr = x.data_ptr()
    out = jt.modwt_denoise_inplace(x, jt.wavelet(DB4), 4)
    assert out.data_ptr() == ptr and out is x
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(TypeError):
        jt.modwt_denoise_inplace(torch.zeros(64, dtype=torch.int32),
                                 jt.wavelet(DB4), 2)


def test_denoise_reduces_mse():
    """The reference demo's claim (MODWTExample.java:125-172) holds."""
    rng = np.random.default_rng(6)
    t = np.linspace(0, 1, 2048)
    clean = np.sign(np.sin(2 * np.pi * 4 * t))
    noisy = clean + 0.35 * rng.normal(size=2048)
    for rule in ("universal", "sure", "bayes"):
        out = jt.modwt_denoise(_t(noisy), jt.wavelet(DB4), 4,
                               threshold=rule).numpy()
        assert np.mean((out - clean) ** 2) < 0.5 * np.mean(
            (noisy - clean) ** 2), rule


# -- the shrink inside the inverse kernel (jwave::modwt_inv_shrink) ----------

# coefficient shapes (batch, N), levels and wavelets: M = 2, 8, 16, lengths
# off a power of two, one (L+1, N) stack of a single signal
SHRINK_SHAPES = [((3, 1001), 3, "Haar"), ((2, 3000), 5, DB4),
                 ((1500,), 4, DB4), ((2, 777), 2, "Symlet 8")]
SHRINK_THRESHOLDS = ["number", "zero", "negative", "per signal",
                     "per level", "scalar tensor"]


def _shrink_case(shape, level, kind, dtype):
    """Coefficients (level+1, *shape) with a NaN in W₁ and both zeros in W₂,
    and the threshold of ``kind`` in their dtype (a number stays one)."""
    rng = np.random.default_rng(level * 1000 + shape[-1])
    c = torch.from_numpy(rng.standard_normal((level + 1,) + shape)
                         .astype(np.float32)).to(dtype)
    c[0].view(-1)[5] = np.nan
    c[1].view(-1)[7], c[1].view(-1)[8] = 0.0, -0.0
    batch = shape[:-1]
    t = {"number": 0.8, "zero": 0.0, "negative": -0.3,
         "per signal": torch.linspace(0.2, 1.0, int(np.prod(batch)))
         .reshape(batch + (1,)),
         "per level": torch.from_numpy(rng.uniform(
             0.1, 1.5, (level,) + batch + (1,)).astype(np.float32)),
         "scalar tensor": torch.tensor(0.7)}[kind]
    return c, t.to(dtype) if isinstance(t, torch.Tensor) else t


def _bits_equal(a, b):
    a, b = a.float(), b.float()
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("kind", SHRINK_THRESHOLDS)
@pytest.mark.parametrize("shape,level,name", SHRINK_SHAPES)
def test_inv_shrink_plain_is_the_plain_pipeline_bitwise(shape, level, name,
                                                        kind, mode, dtype):
    """The shrinking inverse's plain model is bit for bit the inverse
    kernel's plain version of the plain shrink (``imodwt(_shrunk(c))``
    itself in float32, where the CPU's ``imodwt`` computes as the kernel's
    plain version; its bfloat16 path computes in bfloat16, the kernel in
    float32).  A number threshold enters rounded to the coefficients'
    dtype, as the CPU's torch rounds a number against a tensor."""
    from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
    from jwave_pro_tpu_torch.ops import denoise as dn

    w = jt.wavelet(name)
    c, t = _shrink_case(shape, level, kind, dtype)
    c3 = c if c.ndim == 3 else c[:, None]
    if isinstance(t, torch.Tensor):
        thr, value = t.expand(c[:level, ..., :1].shape)[..., 0], 0.0
        thr = thr if c.ndim == 3 else thr[:, None]
    else:
        thr, value = None, float(torch.tensor(t, dtype=dtype))
    shrunk = dn._shrunk(c, level, t, mode)
    got = kc.modwt_inv_shrink_plain(c3, thr, value, w, int(mode != "soft"))
    assert got.dtype == dtype
    got = got.reshape(shape)
    assert _bits_equal(got, kc.modwt_inv_plain(shrunk, w))
    if dtype == torch.float32:
        assert _bits_equal(got, jt.imodwt(shrunk, w))


def _fake(shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, device="cuda", dtype=dtype).requires_grad_(grad)


# (coefficients, threshold) -> (thr's shape, thr's strides, value), or None
# for the plain shrink and imodwt, with soft shrinkage and gradients on
# unless the third item says otherwise; on fake CUDA tensors
SHRINK_DECISIONS = {
    "number": (lambda: (_fake((6, 16, 1000)), 0.8), ((), (), 0.8)),
    "number, bfloat16": (lambda: (_fake((6, 16, 1000), torch.bfloat16),
                                  0.8), ((), (), 0.8)),
    # the card compares a bfloat16 tensor with a number rounded to bfloat16
    "number, bfloat16, hard": (lambda: (_fake((6, 16, 1000), torch.bfloat16),
                                        0.8), ((), (), 0.80078125),
                               {"hard": 1}),
    "number, hard": (lambda: (_fake((6, 16, 1000)), 0.8), ((), (), 0.8),
                     {"hard": 1}),
    "int": (lambda: (_fake((6, 16, 1000)), 1), ((), (), 1.0)),
    "bool": (lambda: (_fake((6, 16, 1000)), True), None),
    "int past 2^53": (lambda: (_fake((6, 16, 1000)), 2 ** 53 + 1), None),
    "per signal": (lambda: (_fake((6, 16, 1000)), _fake((16, 1))),
                   ((5, 16), (0, 1), 0.0)),
    "per level": (lambda: (_fake((6, 16, 1000)), _fake((5, 16, 1))),
                  ((5, 16), (16, 1), 0.0)),
    "scalar tensor": (lambda: (_fake((6, 16, 1000)), _fake(())),
                      ((5, 16), (0, 0), 0.0)),
    "per level, one signal": (lambda: (_fake((6, 1000)), _fake((5, 1))),
                              ((5, 1), (1, 1), 0.0)),
    "per signal, bfloat16": (lambda: (_fake((6, 16, 1000), torch.bfloat16),
                                      _fake((16, 1), torch.bfloat16)),
                             ((5, 16), (0, 1), 0.0)),
    "along time": (lambda: (_fake((6, 16, 1000)), _fake((1000,))), None),
    "per sample": (lambda: (_fake((6, 16, 1000)), _fake((16, 1000))), None),
    "wider than the details": (lambda: (_fake((6, 16, 1000)),
                                        _fake((1, 5, 16, 1))), None),
    "another signal count": (lambda: (_fake((6, 16, 1000)), _fake((8, 1))),
                             None),
    "threshold of another dtype": (lambda: (
        _fake((6, 16, 1000), torch.bfloat16), _fake((16, 1))), None),
    "float64 threshold": (lambda: (_fake((6, 16, 1000)),
                                   _fake((16, 1), torch.float64)), None),
    "float64 coefficients": (lambda: (_fake((6, 16, 1000), torch.float64),
                                      0.8), None),
    "coefficients need a gradient": (lambda: (
        _fake((6, 16, 1000), grad=True), 0.8), None),
    "threshold needs a gradient": (lambda: (
        _fake((6, 16, 1000)), _fake((16, 1), grad=True)), None),
    "gradients off": (lambda: (_fake((6, 16, 1000), grad=True), 0.8),
                      ((), (), 0.8), {"grad": False}),
    "level past the kernel's gate": (lambda: (_fake((13, 2, 8192)), 0.8),
                                     None),
    "three batch axes": (lambda: (_fake((6, 2, 3, 1000)), 0.8), None),
}


@pytest.mark.parametrize("case", sorted(SHRINK_DECISIONS))
def test_shrink_operands_decide_from_the_input(case):
    """Whether the denoise shrinks inside the inverse kernel is a function
    of the coefficients' device, dtype and shape, the threshold's kind,
    dtype and shape, and whether a gradient is wanted; and the operands it
    gives read the threshold as it lies (stride 0 where it broadcasts)."""
    from jwave_pro_tpu_torch.ops import denoise as dn

    make, want, *how = SHRINK_DECISIONS[case]
    how = how[0] if how else {}
    with FakeTensorMode(), torch.set_grad_enabled(how.get("grad", True)):
        c, t = make()
        got = dn._shrink_operands(c, t, jt.wavelet(DB4), how.get("hard", 0))
        if want is None:
            assert got is None
        else:
            thr, value = got
            shape, strides, want_value = want
            if shape:
                assert thr.dtype == c.dtype
                assert (tuple(thr.shape), thr.stride()) == (shape, strides)
            else:
                assert thr is None
            assert value == want_value


def test_shrink_operands_leave_the_cpu_to_the_plain_shrink():
    from jwave_pro_tpu_torch.ops import denoise as dn

    assert dn._shrink_operands(torch.zeros(6, 2, 1000), 0.8,
                               jt.wavelet(DB4), 0) is None


# -- the 2D shrink inside the 2D inverse kernel (jwave::modwt2_inv_shrink) ---

# image shapes ([B,] R, C), levels and wavelets: M = 2, 8, 16, an image
# below the halo, one (3L+1, R, C) stack of a single image
SHRINK2_SHAPES = [((2, 12, 10), 2, "Haar"), ((2, 40, 48), 3, DB4),
                  ((19, 23), 2, DB4), ((2, 17, 21), 1, "Symlet 8")]
SHRINK2_THRESHOLDS = ["number", "zero", "negative", "per image",
                      "per band", "scalar tensor"]


def _shrink2_case(shape, level, kind, dtype):
    """Coefficients (3·level+1, *shape) with a NaN in LH₁, both zeros in
    HL₁ and a NaN in LL_L (which no rule shrinks), and the threshold of
    ``kind`` in their dtype (a number stays one)."""
    rng = np.random.default_rng(level * 1000 + shape[-1])
    c = torch.from_numpy(rng.standard_normal((3 * level + 1,) + shape)
                         .astype(np.float32)).to(dtype)
    c[0].view(-1)[5] = np.nan
    c[1].view(-1)[7], c[1].view(-1)[8] = 0.0, -0.0
    c[-1].view(-1)[3] = np.nan
    batch = shape[:-2]
    t = {"number": 0.8, "zero": 0.0, "negative": -0.3,
         "per image": torch.linspace(0.2, 1.0, int(np.prod(batch)))
         .reshape(batch + (1, 1)),
         "per band": torch.from_numpy(rng.uniform(
             0.1, 1.5, (3 * level,) + batch + (1, 1)).astype(np.float32)),
         "scalar tensor": torch.tensor(0.7)}[kind]
    return c, t.to(dtype) if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("kind", SHRINK2_THRESHOLDS)
@pytest.mark.parametrize("shape,level,name", SHRINK2_SHAPES)
def test_inv2_shrink_plain_is_the_plain_pipeline_bitwise(shape, level, name,
                                                         kind, mode, dtype):
    """The 2D shrinking inverse's plain model is bit for bit the 2D
    inverse kernel's plain version of the plain shrink
    (``imodwt2(_shrunk(c))`` itself in float32); LL_L is never shrunk.  A
    number threshold enters rounded to the coefficients' dtype, as the
    CPU's torch rounds a number against a tensor."""
    from jwave_pro_tpu_torch.kernels import modwt2_cuda as k2
    from jwave_pro_tpu_torch.ops import denoise as dn

    w = jt.wavelet(name)
    c, t = _shrink2_case(shape, level, kind, dtype)
    c4 = c if c.ndim == 4 else c[:, None]
    bands = 3 * level
    if isinstance(t, torch.Tensor):
        thr, value = t.expand(c[:bands, ..., :1, :1].shape)[..., 0, 0], 0.0
        thr = thr if c.ndim == 4 else thr[:, None]
    else:
        thr, value = None, float(torch.tensor(t, dtype=dtype))
    shrunk = dn._shrunk(c, bands, t, mode)
    got = k2.modwt2_inv_shrink_plain(c4, thr, value, w, int(mode != "soft"))
    assert got.dtype == dtype
    got = got.reshape(shape)
    assert _bits_equal(got, k2.modwt2_inv_plain(shrunk, w))
    assert torch.isnan(got).any()          # LL_L's NaN passes through
    if dtype == torch.float32:
        assert _bits_equal(got, jt.imodwt2(shrunk, w))


# (coefficients, threshold) -> (thr's shape, thr's strides, value), or None
# for the plain shrink and imodwt2, with soft shrinkage and gradients on
# unless the third item says otherwise; on fake CUDA tensors of Db4 L3
# coefficients (10, B, R, C)
SHRINK2_DECISIONS = {
    "number": (lambda: (_fake((10, 16, 64, 64)), 0.8), ((), (), 0.8)),
    "number, bfloat16, hard": (lambda: (
        _fake((10, 16, 64, 64), torch.bfloat16), 0.8),
        ((), (), 0.80078125), {"hard": 1}),
    "int": (lambda: (_fake((10, 16, 64, 64)), 1), ((), (), 1.0)),
    "bool": (lambda: (_fake((10, 16, 64, 64)), True), None),
    "per image": (lambda: (_fake((10, 16, 64, 64)), _fake((16, 1, 1))),
                  ((9, 16), (0, 1), 0.0)),
    "per band": (lambda: (_fake((10, 16, 64, 64)), _fake((9, 16, 1, 1))),
                 ((9, 16), (16, 1), 0.0)),
    "scalar tensor": (lambda: (_fake((10, 16, 64, 64)), _fake(())),
                      ((9, 16), (0, 0), 0.0)),
    "per band, one image": (lambda: (_fake((10, 64, 64)), _fake((9, 1, 1))),
                            ((9, 1), (1, 1), 0.0)),
    "per image, one image": (lambda: (_fake((10, 64, 64)), _fake((1, 1))),
                             ((9, 1), (0, 1), 0.0)),
    "per image, bfloat16": (lambda: (
        _fake((10, 16, 64, 64), torch.bfloat16),
        _fake((16, 1, 1), torch.bfloat16)), ((9, 16), (0, 1), 0.0)),
    "along the columns": (lambda: (_fake((10, 16, 64, 64)), _fake((64,))),
                          None),
    "within a band": (lambda: (_fake((10, 16, 64, 64)), _fake((16, 64, 1))),
                      None),
    "per pixel": (lambda: (_fake((10, 16, 64, 64)), _fake((16, 64, 64))),
                  None),
    "wider than the bands": (lambda: (_fake((10, 16, 64, 64)),
                                      _fake((1, 9, 16, 1, 1))), None),
    "another image count": (lambda: (_fake((10, 16, 64, 64)),
                                     _fake((8, 1, 1))), None),
    "threshold of another dtype": (lambda: (
        _fake((10, 16, 64, 64), torch.bfloat16), _fake((16, 1, 1))), None),
    "float64 threshold": (lambda: (_fake((10, 16, 64, 64)),
                                   _fake((16, 1, 1), torch.float64)), None),
    "float64 coefficients": (lambda: (_fake((10, 16, 64, 64),
                                            torch.float64), 0.8), None),
    "coefficients need a gradient": (lambda: (
        _fake((10, 16, 64, 64), grad=True), 0.8), None),
    "threshold needs a gradient": (lambda: (
        _fake((10, 16, 64, 64)), _fake((16, 1, 1), grad=True)), None),
    "gradients off": (lambda: (_fake((10, 16, 64, 64), grad=True), 0.8),
                      ((), (), 0.8), {"grad": False}),
    "level past the inverse's gate": (lambda: (_fake((16, 2, 64, 64)), 0.8),
                                      None),
    "leading axes": (lambda: (_fake((10, 2, 3, 64, 64)), 0.8), None),
}


@pytest.mark.parametrize("case", sorted(SHRINK2_DECISIONS))
def test_shrink2_operands_decide_from_the_input(case):
    """Whether the 2D denoise shrinks inside the 2D inverse kernel is a
    function of the coefficients' device, dtype and shape, the threshold's
    kind, dtype and shape, and whether a gradient is wanted; the operands
    read the threshold as it lies (stride 0 where it broadcasts)."""
    from jwave_pro_tpu_torch.ops import denoise as dn

    make, want, *how = SHRINK2_DECISIONS[case]
    how = how[0] if how else {}
    with FakeTensorMode(), torch.set_grad_enabled(how.get("grad", True)):
        c, t = make()
        got = dn._shrink2_operands(c, t, jt.wavelet(DB4), how.get("hard", 0))
        if want is None:
            assert got is None
        else:
            thr, value = got
            shape, strides, want_value = want
            if shape:
                assert thr.dtype == c.dtype
                assert (tuple(thr.shape), thr.stride()) == (shape, strides)
            else:
                assert thr is None
            assert value == want_value


def test_shrink2_operands_leave_the_cpu_to_the_plain_shrink():
    from jwave_pro_tpu_torch.ops import denoise as dn

    assert dn._shrink2_operands(torch.zeros(10, 2, 64, 64), 0.8,
                                jt.wavelet(DB4), 0) is None
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 40, 48)).astype(np.float32))
    c = jt.modwt2(x, jt.wavelet(DB4), 3)
    assert dn._shrink2_operands(c, 0.8, jt.wavelet(DB4), 0) is None
