"""The port's 2D MODWPT (quad tree) against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:
f64 transforms, tree and best-basis reconstruction 1e-12 absolute (the
same float64 rolls and multiply-adds, or the same host-built spectra
through an FFT); best-basis masks compared exactly, total costs to 1e-9
relative (sums of R·C·4^L logarithms).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

DB4 = "Daubechies 4"


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_pair(name, level, method):
    w = jw.wavelet(name)

    def pair(a):
        c = jw.modwpt2(a, w, level, method)
        return c, jw.imodwpt2(c, w, method)
    return jax.jit(pair)


@pytest.mark.parametrize("name,shape,level,method", [
    (DB4, (32, 48), 2, "direct"),
    (DB4, (2, 37, 53), 2, "auto"),      # odd sizes; 'auto' picks per length
    ("Haar", (2, 2, 16, 24), 3, "direct"),  # leading dims
    ("Symlet 8", (2, 40, 24), 1, "fft"),
])
def test_modwpt2_imodwpt2_match_jax_f64(name, shape, level, method):
    wt = jt.wavelet(name)
    x = np.random.default_rng(level).standard_normal(shape)
    want_c, want_x = (np.asarray(a) for a in _jax_pair(name, level, method)(x))
    got = jt.modwpt2(_t(x), wt, level, method)
    p = 1 << level
    assert got.dtype == torch.float64 and got.shape == (p, p) + shape
    np.testing.assert_allclose(got.numpy(), want_c, rtol=0, atol=1e-12)
    back = jt.imodwpt2(_t(want_c), wt, method)
    assert back.shape == shape
    np.testing.assert_allclose(back.numpy(), want_x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-10)


def test_node_00_is_modwt2_ll_and_energy_is_kept():
    wt = jt.wavelet(DB4)
    x = _t(np.random.default_rng(1).standard_normal((2, 32, 40)))
    c = jt.modwpt2(x, wt, 2, "direct")
    torch.testing.assert_close(c[0, 0], jt.modwt2(x, wt, 2)[-1], rtol=0,
                               atol=1e-12)
    torch.testing.assert_close((c ** 2).sum(dim=(0, 1)).sum(),
                               (x ** 2).sum(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", [DB4, "Haar"])
def test_modwpt2_tree_matches_jax_f64(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(2).standard_normal((2, 24, 32))
    want = jax.jit(lambda a: jw.modwpt2_tree(a, wj, 2, "direct"))(x)
    got = jt.modwpt2_tree(_t(x), wt, 2, "direct")
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("cost", ["shannon", "logenergy", "threshold",
                                  "sure"])
def test_modwpt2_best_basis_and_reconstruct_match_jax_f64(cost):
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    rng = np.random.default_rng(3)
    r = np.arange(32)[:, None]
    c = np.arange(32)[None, :]
    x = (np.sin(2 * np.pi * 0.3 * r) * np.cos(2 * np.pi * 0.1 * c))[None] \
        + 0.3 * rng.standard_normal((2, 32, 32))
    masks_w, cost_w, tree_w = jax.jit(
        lambda a: jw.modwpt2_best_basis(a, wj, 2, cost, "direct"))(x)
    masks, total, tree = jt.modwpt2_best_basis(_t(x), wt, 2, cost, "direct")
    for m, mw in zip(masks, masks_w):
        assert m.dtype == torch.bool
        np.testing.assert_array_equal(m.numpy(), np.asarray(mw))
    np.testing.assert_allclose(float(total), float(cost_w), rtol=1e-9)
    # every pixel's frequency cell is covered by exactly one leaf
    covered = sum(m.repeat_interleave(1 << (2 - l), 0).repeat_interleave(
        1 << (2 - l), 1).long() for l, m in enumerate(masks))
    assert bool(torch.all(covered == 1))
    rec = jt.modwpt2_basis_reconstruct(tree, masks, wt, "direct")
    rec_w = jw.modwpt2_basis_reconstruct(
        [jnp.asarray(t) for t in tree_w], masks_w, wj, "direct")
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_w), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10)


def test_validation():
    wt = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="at least 2 dims"):
        jt.modwpt2(torch.zeros(64), wt, 2)
    with pytest.raises(ValueError, match="exceeds"):
        jt.modwpt2(torch.zeros(64, 8), wt, 4)
    with pytest.raises(ValueError, match="equal powers of two"):
        jt.imodwpt2(torch.zeros(4, 2, 8, 8), wt)
    with pytest.raises(ValueError, match="expects"):
        jt.imodwpt2(torch.zeros(4, 4, 8), wt)
    # the packet kernels' 'pallas' spelling raises on the CPU, per axis
    with pytest.raises(ValueError, match="fused kernel unavailable"):
        jt.modwpt2(torch.zeros(16, 16), wt, 2, "pallas")
