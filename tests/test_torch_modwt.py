"""The port's MODWT against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 transforms, 1e-12 absolute: both run the same float64 arithmetic
  (rolls and multiply-adds, or the same host-built spectra through an FFT);
  only FFT library rounding differs, ~1e-15 at these sizes.
* the kernels' plain versions against the JAX Pallas kernels in interpret
  mode, f32, 2e-5 absolute: the bound ``tests/test_pallas_kernels.py``
  holds the Pallas kernels to; both compute in f32 in a different order.
* bf16 I/O, one bf16 ulp (relative 2⁻⁷): both compute in f32 and round
  once; the f32 results may straddle a bf16 rounding boundary.
"""
import functools
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.modwt_pallas import (
    imodwt_fused as jax_imodwt_fused, modwt_fused as jax_modwt_fused,
)
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc

port_modwt_module = importlib.import_module("jwave_pro_tpu_torch.ops.modwt")

REPO = Path(__file__).resolve().parent.parent
GOLDEN = np.load(REPO / "tests" / "golden" / "golden.npz")
GOLDEN_MODWT = sorted(k for k in GOLDEN.files if k.startswith("modwt_"))
WAVELETS = ["Daubechies 4", "Symlet 8", "Haar", "BiOrthogonal 3/5",
            "Discrete Meyer"]
# (shape, level): power of 2, odd and 100-sample signals; 1D and batched;
# every level 1..5.  Discrete Meyer's 62 taps make each JAX level a large
# graph to compile, so it runs the shallow cases only.
CASES = [((64,), 5), ((2, 101), 3), ((3, 100), 1), ((2, 64), 4),
         ((101,), 2)]
SHALLOW_CASES = [((64,), 2), ((2, 101), 1), ((100,), 1)]
ORTHOGONAL = ("Daubechies 4", "Symlet 8", "Haar")
DB4 = "Daubechies 4"


@functools.lru_cache(maxsize=None)
def _jax(fn, *static):
    """JIT the JAX function once per static arguments (eager JAX compiles
    every roll separately and is far slower)."""
    if fn == "modwt":
        return jax.jit(lambda x: jw.modwt(x, *static))
    if fn == "imodwt":
        return jax.jit(lambda c: jw.imodwt(c, *static))
    return jax.jit(lambda x: jw.modwt_mra(x, *static))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("method", ["direct", "fft", "auto_reference"])
@pytest.mark.parametrize("name", WAVELETS)
def test_modwt_imodwt_match_jax_f64(name, method):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    rng = np.random.default_rng(WAVELETS.index(name))
    for shape, level in (SHALLOW_CASES if name == "Discrete Meyer"
                         else CASES):
        x = rng.standard_normal(shape)
        want = np.asarray(_jax("modwt", wj, level, method)(x))
        got = jt.modwt(_t(x), wt, level, method=method)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12,
                                   err_msg=f"{name} {shape} L{level}")
        back_want = np.asarray(_jax("imodwt", wj, method)(want))
        back = jt.imodwt(_t(want), wt, method=method)
        np.testing.assert_allclose(back.numpy(), back_want, rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("name", WAVELETS)
def test_auto_and_mra_match_jax_f64(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 100))
    for level in (1,) if name == "Discrete Meyer" else (1, 3):
        want = np.asarray(_jax("modwt", wj, level, "auto")(x))
        np.testing.assert_allclose(jt.modwt(_t(x), wt, level).numpy(), want,
                                   rtol=0, atol=1e-12)
        mra = np.asarray(_jax("mra", wj, level, "direct")(x))
        got = jt.modwt_mra(_t(x), wt, level, method="direct").numpy()
        np.testing.assert_allclose(got, mra, rtol=0, atol=1e-12)
        # additive decomposition x = Σ D_j + S_J (orthogonal wavelets)
        if name in ORTHOGONAL:
            np.testing.assert_allclose(got.sum(0), x, atol=1e-10)


@pytest.mark.parametrize("key", GOLDEN_MODWT)
def test_golden_modwt_l4(key):
    """tests/golden/golden.npz's float64 oracle vectors (as test_golden)."""
    w = jt.wavelet(key[6:-3].replace("_", " ").replace("-", "/"))
    got = jt.modwt(_t(GOLDEN["input_100"]), w, 4, method="direct")
    np.testing.assert_allclose(got.numpy(), GOLDEN[key], atol=1e-10,
                               err_msg=key)


def test_circular_convolve_pair_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 37))
    f = rng.standard_normal(5)
    for jf, tf in ((jw.circular_convolve, jt.circular_convolve),
                   (jw.circular_convolve_adjoint,
                    jt.circular_convolve_adjoint)):
        np.testing.assert_allclose(tf(_t(x), f).numpy(),
                                   np.asarray(jf(x, f)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,level", [(64, 0), (64, 14), (64, 7), (100, 7),
                                     (1, 1)])
def test_check_level_errors_identical(n, level):
    x = np.zeros(n)
    with pytest.raises(ValueError) as jax_err:
        jw.modwt(x, jw.wavelet(DB4), level, method="direct")
    with pytest.raises(ValueError) as port_err:
        jt.modwt(_t(x), jt.wavelet(DB4), level, method="direct")
    assert str(port_err.value) == str(jax_err.value)


def test_integer_input_is_cast_to_float32():
    x = np.arange(64) % 7
    got = jt.modwt(torch.from_numpy(x), jt.wavelet(DB4), 2)
    want = np.asarray(_jax("modwt", jw.wavelet(DB4), 2, "auto")(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_composite_multipliers_are_cached_host_constants():
    w = jt.wavelet(DB4)
    a = port_modwt_module._composite_fft_multipliers(w, 3, 100)
    assert a is port_modwt_module._composite_fft_multipliers(w, 3, 100)
    assert a.dtype == np.complex128 and a.shape == (4, 51)


def test_cpu_dispatch_never_takes_the_kernel_route():
    x = torch.zeros(8, 2048)
    w = jt.wavelet(DB4)
    assert port_modwt_module._try_kernel(x, w, 3) is None
    with pytest.raises(ValueError, match="fused kernel unavailable"):
        jt.modwt(x, w, 3, method="pallas")
    with pytest.raises(ValueError, match="fused kernel unavailable"):
        jt.imodwt(torch.zeros(4, 8, 2048), w, method="pallas")


# -- the kernels' plain versions against the JAX Pallas kernels --------------

@pytest.mark.parametrize("batch,n,level", [
    (8, 2048, 3),      # the JAX kernel tests' base shape
    (16, 2048, 2),
    (8, 2000, 3),      # arbitrary N (padded plan in the JAX kernel)
])
def test_fused_plain_matches_jax_interpret(batch, n, level):
    rng = np.random.default_rng(batch * n + level)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt_fused(jnp.asarray(x), wj, level,
                                      interpret=True))
    got = kc.modwt_fused(_t(x), wt, level)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    back_want = np.asarray(jax_imodwt_fused(jnp.asarray(want), wj,
                                            interpret=True))
    back = kc.imodwt_fused(_t(want), wt)
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=2e-5)


def test_fused_plain_1d_contract_matches_jax_interpret():
    """(N,) → (L+1, N): the JAX package's flat kernel (L ≥ 4)."""
    x = np.random.default_rng(11).standard_normal(1 << 14).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt_fused(jnp.asarray(x), wj, 4, interpret=True))
    got = kc.modwt_fused(_t(x), wt, 4)
    assert got.shape == (5, 1 << 14)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    back = kc.imodwt_fused(got, wt)
    assert back.shape == (1 << 14,)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=2e-5)


def test_fused_plain_bf16_matches_jax_interpret():
    x = np.random.default_rng(5).standard_normal((8, 2048)).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt_fused(jnp.asarray(x, jnp.bfloat16), wj, 3,
                                      interpret=True).astype(jnp.float32))
    got = kc.modwt_fused(_t(x).bfloat16(), wt, 3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    back_want = np.asarray(jax_imodwt_fused(
        jnp.asarray(want, jnp.bfloat16), wj, interpret=True
    ).astype(jnp.float32))
    back = kc.imodwt_fused(_t(want).bfloat16(), wt)
    assert back.dtype == torch.bfloat16
    np.testing.assert_allclose(back.float().numpy(), back_want,
                               rtol=2 ** -7, atol=1e-6)


def test_plain_versions_compute_in_f32_for_bf16():
    """bf16 in, bf16 out, f32 arithmetic in between (not bf16 arithmetic)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 512)).astype(np.float32)).bfloat16()
    w = jt.wavelet(DB4)
    got = kc.modwt_fwd_plain(x, w, 3)
    want = kc.modwt_fwd_plain(x.float(), w, 3).bfloat16()
    assert torch.equal(got, want)
    assert torch.equal(kc.modwt_inv_plain(got, w),
                       kc.modwt_inv_plain(got.float(), w).bfloat16())


def test_kernel_supported_budget():
    # Db4 L5: exact halo 7·31 = 217, every kernel fits
    assert kc.halo(8, 5) == 217
    for kind in ("fwd", "inv", "denoise"):
        assert kc.kernel_supported(1 << 20, 5, 8, kind)
        assert kc.kernel_supported(100003, 5, 8, kind)   # any N
        assert kc.smem_bytes(5, 8, kind) <= kc.SMEM_LIMIT
    # Db4 L13: 57,337-sample halo does not fit a block's shared memory
    assert kc.halo(8, 13) == 57337
    assert not any(kc.kernel_supported(1 << 20, 13, 8, k)
                   for k in ("fwd", "inv", "denoise"))
    assert kc.smem_bytes(5, 8, "denoise") > 48 * 1024   # needs the attribute
    assert not kc.kernel_supported(1 << 20, 2, 65, "fwd")  # > MAX_TAPS


def test_fused_wrappers_raise_on_unsupported_shapes():
    w = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="unsupported shape"):
        kc.modwt_fused(torch.zeros(1 << 13), w, 13)
    with pytest.raises(ValueError):
        kc.modwt_fused(torch.zeros(2, 2, 64), w, 2)
    with pytest.raises(ValueError):
        kc.modwt_fwd_cuda(torch.zeros(2, 64), w, 2)   # not a CUDA tensor


@pytest.mark.parametrize("shape", [(2, 64), (96,)])
def test_gradcheck_autograd_pair_f64(shape):
    """Backward of each direction is the other kernel (Aᵀ = A⁻¹); on the
    CPU both run their plain versions, so gradcheck sees the exact pair."""
    w = jt.wavelet(DB4)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: kc.modwt_fused(v, w, 2), (x,))
    c = torch.randn((3,) + shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: kc.imodwt_fused(v, w), (c,))


def test_import_leaves_jax_out():
    code = ("import sys, jwave_pro_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'jwave_pro_tpu' or m.startswith('jwave_pro_tpu.')]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
