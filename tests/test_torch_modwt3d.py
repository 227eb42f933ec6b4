"""The port's 3D MODWT, 3D denoise and oct-tree packets against the JAX
package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 transforms, MRA, denoise and packets, 1e-12 absolute: both run the
  same float64 rolls and multiply-adds (the JAX package transposes each
  axis to the last around its rolls, the port rolls it in place: the same
  values); hard thresholding is discontinuous, but the inputs are random,
  so no coefficient sits within rounding of a threshold.
* the 3D kernels' plain versions against the JAX Pallas kernels in
  interpret mode, f32, 1e-4 absolute: the bound
  ``tests/test_pallas_kernels.py`` holds the 3D Pallas kernels to; both
  compute in f32 in another order.  Interpret mode runs only where
  ``pallas3d_supported`` admits the shape (R·C a multiple of 128).
* the gradient through the plain path against ``jax.grad`` of the direct
  path, f64, 1e-12.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.modwt3_pallas import (
    imodwt3_fused as jax_imodwt3_fused,
    modwt3_fused as jax_modwt3_fused,
)
from jwave_pro_tpu_torch.kernels import modwt3_cuda as k3
from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp
from jwave_pro_tpu_torch.kernels.modwt_cuda import LAUNCHES

DB4 = "Daubechies 4"
# (name, shape, level): non-cubic sizes, halo (Db4 L3: 49) larger than
# every axis, a leading batch axis, an unbatched volume
CASES = [(DB4, (2, 6, 10, 12), 2), (DB4, (1, 8, 8, 16), 3),
         ("Haar", (5, 7, 9), 2), ("Symlet 8", (1, 6, 10, 12), 1)]


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_pair(name, level):
    """JIT forward and inverse (direct path) once per wavelet and level."""
    w = jw.wavelet(name)

    def pair(a):
        c = jw.modwt3(a, w, level, method="direct")
        return c, jw.imodwt3(c, w, method="direct")
    return jax.jit(pair)


@functools.lru_cache(maxsize=None)
def _jax_denoise(level, mode, threshold):
    w = jw.wavelet(DB4)
    return jax.jit(lambda a, t=None: jw.modwt3_denoise(
        a, w, level, mode, threshold if t is None else t))


@pytest.mark.parametrize("name,shape,level", CASES)
def test_modwt3_imodwt3_match_jax_f64(name, shape, level):
    wt = jt.wavelet(name)
    x = np.random.default_rng(level).standard_normal(shape)
    want_c, want_x = (np.asarray(a) for a in _jax_pair(name, level)(x))
    for method in ("direct", "auto"):
        got = jt.modwt3(_t(x), wt, level, method=method)
        assert got.dtype == torch.float64 and got.shape == want_c.shape
        np.testing.assert_allclose(got.numpy(), want_c, rtol=0, atol=1e-12,
                                   err_msg=f"{name} {shape} {method}")
        back = jt.imodwt3(_t(want_c), wt, method=method)
        np.testing.assert_allclose(back.numpy(), want_x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(want_x, x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name,shape,level", [
    ("Haar", (2, 6, 8, 10), 2), (DB4, (6, 8, 10), 1),
])
def test_modwt3_mra_matches_jax_f64(name, shape, level):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(3).standard_normal(shape)
    want = np.asarray(jax.jit(lambda a: jw.modwt3_mra(a, wj, level))(x))
    got = jt.modwt3_mra(_t(x), wt, level)
    assert got.shape == want.shape == (7 * level + 1,) + shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(0).numpy(), x, rtol=0, atol=1e-10)


def test_octant_order_and_letters():
    """Rows (LLH, LHL, LHH, HLL, HLH, HHL, HHH) per level, LLL last; letters
    (depth, row, col), L = g and H = h along that axis — built here from
    the port's 1D transform."""
    wt = jt.wavelet(DB4)
    x = _t(np.random.default_rng(4).standard_normal((2, 8, 12, 16)))

    def one(a, axis, letter):      # g (L) or h (H) along ``axis``, level 1
        c = jt.modwt(a.movedim(axis, -1), wt, 1, method="direct")
        return c[1 if letter == "L" else 0].movedim(-1, axis)

    got = jt.modwt3(x, wt, 1)
    names = ["LLH", "LHL", "LHH", "HLL", "HLH", "HHL", "HHH", "LLL"]
    for k, (d, r, c) in enumerate(names):
        band = one(one(one(x, -1, c), -2, r), -3, d)
        torch.testing.assert_close(got[k], band, rtol=0, atol=1e-13,
                                   msg=names[k])


def test_integer_input_and_validation():
    wj, wt = jw.wavelet("Haar"), jt.wavelet("Haar")
    xi = np.arange(8 * 8 * 16).reshape(8, 8, 16) % 7
    got = jt.modwt3(torch.from_numpy(xi), wt, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jw.modwt3(xi, wj, 2)),
                               atol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        jt.modwt3(torch.zeros(4, 64, 64), wt, 3)
    with pytest.raises(ValueError, match="7·level\\+1"):
        jt.imodwt3(torch.zeros(9, 4, 4, 4), wt)
    for fn in (lambda: jt.modwt3(torch.zeros(8, 8, 8), wt, 1, method="fft"),
               lambda: jt.imodwt3(torch.zeros(8, 4, 4, 4), wt,
                                  method="fft")):
        with pytest.raises(ValueError, match="unknown method"):
            fn()


# -- the gate --------------------------------------------------------------

def test_gate_on_cpu_pallas_raises_and_auto_is_plain():
    wt = jt.wavelet(DB4)
    x = torch.zeros(2, 8, 8, 16)
    for fn in (lambda: jt.modwt3(x, wt, 2, method="pallas"),
               lambda: jt.imodwt3(torch.zeros(15, 2, 8, 8, 16), wt,
                                  method="pallas")):
        with pytest.raises(ValueError, match="unavailable"):
            fn()
    before = [LAUNCHES["modwt3_fwd"], LAUNCHES["modwt3_inv"]]
    jt.imodwt3(jt.modwt3(x, wt, 2), wt)
    jt.modwt3_denoise(x + 1.0, wt, 1)
    assert [LAUNCHES["modwt3_fwd"],
            LAUNCHES["modwt3_inv"]] == before


def test_requires_grad_takes_plain_path_and_matches_jax_grad():
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 8, 10))
    wts = rng.standard_normal((8, 2, 6, 8, 10))

    def loss_j(a):
        c = jw.modwt3(a, wj, 1, method="direct")
        return jnp.sum(c * wts) + jnp.sum(
            jw.imodwt3(c * c, wj, method="direct") ** 2)

    want = np.asarray(jax.jit(jax.grad(loss_j))(x))
    xt = _t(x).requires_grad_()
    c = jt.modwt3(xt, wt, 1)
    assert c.grad_fn is not None
    loss = (c * _t(wts)).sum() + (jt.imodwt3(c * c, wt) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-12)


# -- the kernels' plain versions against the JAX Pallas kernels ---------------

@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (2, 24, 8, 16)])
def test_3d_plain_versions_match_jax_interpret(shape):
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(
        np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt3_fused(jnp.asarray(x), wj, 2,
                                       interpret=True))
    got = k3.modwt3_fused(_t(x), wt, 2)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    back_want = np.asarray(jax_imodwt3_fused(jnp.asarray(want), wj,
                                             interpret=True))
    back = k3.imodwt3_fused(_t(want), wt)
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-4)


def test_3d_plain_bf16_rounds_once():
    """bf16 in and out, f32 arithmetic: the f32 result rounded once."""
    x = _t(np.random.default_rng(7).standard_normal((2, 6, 8, 12)).astype(
        np.float32)).bfloat16()
    w = jt.wavelet(DB4)
    c = k3.modwt3_fwd_plain(x, w, 1)
    assert c.dtype == torch.bfloat16
    assert torch.equal(c, k3.modwt3_fwd_plain(x.float(), w, 1).bfloat16())
    assert torch.equal(k3.modwt3_inv_plain(c, w),
                       k3.modwt3_inv_plain(c.float(), w).bfloat16())


def test_kernel3d_supported_budget():
    db4, sym8, haar = 8, 16, 2
    # Db4 L1-L2, Haar L1-L5, Symlet 8 at L1; the forward's block rows per
    # level: 16 at Db4 (two blocks an SM), more where the rings are small
    assert k3.fwd3_rows(7, db4) == k3.fwd3_rows(14, db4) == 16
    assert k3.fwd3_rows(1, haar) == 64 and k3.fwd3_rows(15, sym8) == 16
    assert k3.kernel3d_supported(256, 256, 256, 2, db4, "fwd")
    assert k3.kernel3d_supported(256, 256, 256, 2, db4, "inv")
    assert not k3.kernel3d_supported(256, 256, 256, 3, db4, "fwd")
    assert k3.kernel3d_supported(2, 3, 5, 2, db4, "fwd")     # halo > axes
    assert k3.kernel3d_supported(64, 64, 64, 5, haar, "inv")
    assert not k3.kernel3d_supported(64, 64, 64, 6, haar, "inv")
    assert k3.kernel3d_supported(9, 9, 9, 1, sym8, "fwd")
    assert not k3.kernel3d_supported(9, 9, 9, 2, sym8, "fwd")
    # the forward takes the inverse's range, h <= 21
    assert k3.fwd3_rows(20, db4) is not None
    assert k3.fwd3_rows(21, 22) is not None and k3.inv3_fits(21, 22)
    assert k3.fwd3_rows(22, 23) is None and not k3.inv3_fits(22, 23)
    for level, m in ((2, db4), (5, haar), (1, sym8)):
        for j in range(1, level + 1):
            h = k3.level_halo(m, j)
            tr = k3.fwd3_rows(h, m)
            # the rings fit 227 KB (two blocks an SM where tr > 16), and
            # the next larger block of rows would not keep two an SM
            assert k3.fwd3_smem_bytes(h, m, tr) <= 232_448
            if tr < 64:
                assert k3.fwd3_smem_bytes(h, m, tr + 16) + 1024 > 233_472 // 2
    # the depth runs fill the card: (4, 256³) Db4 L2 on 132 SMs
    assert [k3.fwd3_depth_run(4, 256, 256, 256, h, db4, 132)
            for h in (7, 14)] == [86, 86]
    assert k3.fwd3_depth_run(1, 5, 8, 8, 14, db4, 132) == 5
    with pytest.raises(ValueError, match="kind"):
        k3.kernel3d_supported(8, 8, 8, 1, db4, "denoise")


def test_fused_wrappers_raise_on_unsupported_input():
    w = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="unsupported shape"):
        k3.modwt3_fused(torch.zeros(16, 16, 16), w, 3)
    with pytest.raises(ValueError):
        k3.modwt3_fused(torch.zeros(2, 2, 8, 8, 8), w, 1)
    with pytest.raises(ValueError, match="7L\\+1"):
        k3.imodwt3_fused(torch.zeros(9, 8, 8, 8), w)
    for launch in (lambda: k3.modwt3_fwd_cuda(torch.zeros(2, 8, 8, 8), w, 1),
                   lambda: k3.modwt3_inv_cuda(torch.zeros(8, 2, 8, 8, 8), w)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch()
    # (D, R, C) runs as B = 1
    x = _t(np.random.default_rng(8).standard_normal((6, 8, 10)))
    torch.testing.assert_close(k3.modwt3_fused(x, w, 1),
                               k3.modwt3_fused(x[None], w, 1)[:, 0])


# -- modwt3_denoise -----------------------------------------------------------

@pytest.mark.parametrize("rule,mode", [
    (None, "soft"), ("universal", "hard"), ("sure", "soft"),
    ("bayes", "soft"), (0.7, "soft"), (0.7, "hard"),
])
def test_modwt3_denoise_matches_jax_f64(rule, mode):
    x = np.random.default_rng(9).standard_normal((2, 6, 8, 12))
    want = np.asarray(_jax_denoise(1, mode, rule)(x))
    got = jt.modwt3_denoise(_t(x), jt.wavelet(DB4), 1, mode, threshold=rule)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_per_volume_threshold_matches_jax_b111():
    """A (B,) array is per volume: the port equals the JAX pipeline given
    the JAX-safe (B, 1, 1, 1) shape."""
    x = np.random.default_rng(10).standard_normal((3, 6, 8, 10))
    thr = np.array([0.3, 0.6, 1.2])
    want = np.asarray(_jax_denoise(1, "soft", None)(
        x, thr[:, None, None, None]))
    w = jt.wavelet(DB4)
    for t in (thr, _t(thr), thr[:, None, None, None]):
        got = jt.modwt3_denoise(_t(x), w, 1, threshold=t)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_per_volume_contract_differs_from_jax_per_column():
    """B == C: the (B,) array still means one threshold per volume here,
    where the JAX pipeline broadcasts it against the last axis (one
    threshold per column) — the contract ROADMAP Queue 3 records."""
    x = np.random.default_rng(11).standard_normal((4, 6, 8, 4))
    thr = np.array([0.25, 0.5, 1.0, 2.0])
    w = jt.wavelet(DB4)
    got = jt.modwt3_denoise(_t(x), w, 1, threshold=thr).numpy()
    per_volume = np.stack([jt.modwt3_denoise(_t(x[b]), w, 1,
                                             threshold=float(thr[b])).numpy()
                           for b in range(4)])
    np.testing.assert_allclose(got, per_volume, rtol=0, atol=1e-12)
    jax_raw = np.asarray(_jax_denoise(1, "soft", None)(x, thr))
    assert np.abs(jax_raw - got).max() > 1e-3


def test_pipeline_numpy_threshold_keeps_float32():
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (3, 6, 8, 10)).astype(np.float32))
    thr = np.array([0.3, 0.6, 1.2])
    w = jt.wavelet(DB4)
    got = jt.modwt3_denoise(x, w, 1, threshold=thr)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, jt.modwt3_denoise(x, w, 1, threshold=torch.tensor(
            thr, dtype=torch.float32)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown threshold rule"):
        jt.modwt3_denoise(x, w, 1, threshold="nope")


def test_modwt3_denoise_reduces_mse():
    rng = np.random.default_rng(14)
    d, r, c = np.meshgrid(np.arange(16), np.arange(16), np.arange(16),
                          indexing="ij")
    clean = np.sign(np.sin(2 * np.pi * d / 16)) * np.cos(2 * np.pi * c / 16)
    noisy = clean + 0.3 * rng.normal(size=clean.shape)
    out = jt.modwt3_denoise(_t(noisy), jt.wavelet(DB4), 1).numpy()
    assert np.mean((out - clean) ** 2) < 0.5 * np.mean((noisy - clean) ** 2)


# -- modwpt3 / imodwpt3 -------------------------------------------------------

@pytest.mark.parametrize("name,shape,level", [
    ("Haar", (2, 8, 12, 16), 2), (DB4, (6, 8, 10), 1),
])
def test_modwpt3_matches_jax_f64(name, shape, level):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(12).standard_normal(shape)
    want = np.asarray(jax.jit(lambda a: jw.modwpt3(a, wj, level,
                                                   method="direct"))(x))
    got = jt.modwpt3(_t(x), wt, level)
    p = 1 << level
    assert got.shape == want.shape == (p, p, p) + shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    back_want = np.asarray(jax.jit(lambda c: jw.imodwpt3(
        c, wj, method="direct"))(want))
    back = jt.imodwpt3(_t(want), wt)
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-10)
    # node (0, 0, 0) is the 3D MODWT's LLL
    np.testing.assert_allclose(
        got[0, 0, 0].numpy(), jt.modwt3(_t(x), wt, level)[-1].numpy(),
        rtol=0, atol=1e-12)


def test_modwpt3_validation_and_cpu_dispatch():
    w = jt.wavelet("Haar")
    with pytest.raises(ValueError, match="at least 3 dims"):
        jt.modwpt3(torch.zeros(8, 8), w, 1)
    with pytest.raises(ValueError, match="expects"):
        jt.imodwpt3(torch.zeros(2, 2, 2, 8, 8), w)
    with pytest.raises(ValueError, match="powers of two"):
        jt.imodwpt3(torch.zeros(2, 2, 4, 4, 4, 4), w)
    before = [LAUNCHES["modwpt_fwd"], LAUNCHES["modwpt_inv"]]
    jt.imodwpt3(jt.modwpt3(torch.ones(4, 4, 4), w, 1), w)
    assert [LAUNCHES["modwpt_fwd"],
            LAUNCHES["modwpt_inv"]] == before


@pytest.mark.parametrize("m", [2, 4, 8, 16, 21, 22])
def test_inverse_gate_at_least_as_wide_as_the_forward(m):
    """Every level the forward's windows take, the inverse's patches and
    ring take too (halo ≤ 20), and the inverse also takes halo 21."""
    for level in range(1, k3.MAX_LEVELS3 + 1):
        if k3.kernel3d_supported(64, 64, 64, level, m, "fwd"):
            assert k3.kernel3d_supported(64, 64, 64, level, m, "inv")
    for h in range(0, 22):
        if m - 1 <= h:
            assert k3.inv3_fits(h, m) == (h <= 21)
    assert not k3.inv3_fits(22, m)


@pytest.mark.parametrize("h,m", [(1, 2), (7, 8), (14, 8), (15, 16), (20, 21),
                                 (21, 22)])
def test_inverse_shared_memory_fits_the_block(h, m):
    assert k3.inv3_fits(h, m)
    assert k3.inv3_smem_bytes(h, m) <= 232_448
    # eight patches, four column adjoints and two rings of M planes
    pr, pc = 16 + h, 32 + h
    assert k3.inv3_smem_bytes(h, m) == 4 * (128 + 8 * pr * pc + 4 * pr * 32
                                            + 2 * m * 512)


@pytest.mark.parametrize("shape,h,m,want", [
    ((4, 256, 256, 256), 14, 8, 86),   # 512 column tiles: three runs
    ((4, 256, 256, 256), 7, 8, 86),
    ((1, 128, 128, 128), 14, 8, 28),   # few tiles: runs of 2h
    ((2, 64, 64, 64), 7, 8, 14),
    ((1, 8, 8, 16), 14, 8, 8),         # never longer than the volume
    ((1, 100, 16, 32), 1, 2, 8),       # never shorter than 8 planes
])
def test_inverse_depth_run(shape, h, m, want):
    assert k3.inv3_depth_run(*shape, h, m, sms=132) == want
