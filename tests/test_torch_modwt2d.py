"""The port's 2D MODWT and 2D denoise against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 transforms, MRA and the denoise pipeline, 1e-12 absolute: both run
  the same float64 rolls and multiply-adds (the JAX package transposes the
  row axis around its rolls, the port rolls it in place: the same values);
  hard thresholding is discontinuous, but the inputs are random, so no
  coefficient sits within rounding of a threshold.
* the 2D kernels' plain versions against the JAX Pallas kernels in
  interpret mode, f32, 2e-5 absolute: the bound
  ``tests/test_pallas_kernels.py`` holds the Pallas kernels to; both
  compute in f32 in another order.
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
from jwave_pro_tpu.kernels.modwt2_pallas import (
    imodwt2_fused as jax_imodwt2_fused,
    modwt2_denoise_fused as jax_denoise2_fused,
    modwt2_fused as jax_modwt2_fused,
)
from jwave_pro_tpu_torch.kernels import modwt2_cuda as k2
from jwave_pro_tpu_torch.kernels._launch import LAUNCHES

DB4 = "Daubechies 4"
WAVELETS = [DB4, "Haar", "Symlet 8"]
# (shape, level): square-free sizes, halo (Db4 L3: 49) larger than both
# image sides, leading dims
SHAPES = [((64, 96), 3), ((2, 37, 53), 3), ((2, 40, 24), 3),
          ((2, 2, 24, 32), 2)]


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_pair(name, level):
    """JIT forward and inverse (direct path) once per wavelet and level."""
    w = jw.wavelet(name)

    def pair(a):
        c = jw.modwt2(a, w, level, method="direct")
        return c, jw.imodwt2(c, w, method="direct")
    return jax.jit(pair)


@functools.lru_cache(maxsize=None)
def _jax_denoise(level, mode, threshold):
    w = jw.wavelet(DB4)
    return jax.jit(lambda a, t=None: jw.modwt2_denoise(
        a, w, level, mode, threshold if t is None else t, method="auto"))


@pytest.mark.parametrize("shape,level", SHAPES)
@pytest.mark.parametrize("name", WAVELETS)
def test_modwt2_imodwt2_match_jax_f64(name, shape, level):
    wt = jt.wavelet(name)
    x = np.random.default_rng(WAVELETS.index(name)).standard_normal(shape)
    want_c, want_x = (np.asarray(a) for a in _jax_pair(name, level)(x))
    for method in ("direct", "auto"):
        got = jt.modwt2(_t(x), wt, level, method=method)
        assert got.dtype == torch.float64 and got.shape == want_c.shape
        np.testing.assert_allclose(got.numpy(), want_c, rtol=0, atol=1e-12,
                                   err_msg=f"{name} {shape} {method}")
        back = jt.imodwt2(_t(want_c), wt, method=method)
        np.testing.assert_allclose(back.numpy(), want_x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(want_x, x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name,shape,level", [
    (DB4, (2, 37, 53), 2), ("Haar", (40, 24), 3), ("Symlet 8", (2, 24, 32), 1),
])
def test_modwt2_mra_matches_jax_f64(name, shape, level):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(3).standard_normal(shape)
    want = np.asarray(jax.jit(lambda a: jw.modwt2_mra(a, wj, level))(x))
    got = jt.modwt2_mra(_t(x), wt, level)
    assert got.shape == want.shape == (3 * level + 1,) + shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(0).numpy(), x, rtol=0, atol=1e-10)


def test_band_order_and_letters():
    """Rows (LH, HL, HH) per level, LL last; letters (row, col), L = g and
    H = h along that axis — built here from the port's 1D transform."""
    wt = jt.wavelet(DB4)
    x = _t(np.random.default_rng(4).standard_normal((2, 32, 48)))

    def one(a, axis):      # (W_1, V_1) along ``axis``
        c = jt.modwt(a.movedim(axis, -1), wt, 1, method="direct")
        return c[0].movedim(-1, axis), c[1].movedim(-1, axis)

    h_cols, g_cols = one(x, -1)
    lh = one(h_cols, -2)[1]       # g along rows of the h-column pass
    hl = one(g_cols, -2)[0]
    hh = one(h_cols, -2)[0]
    ll = one(g_cols, -2)[1]
    got = jt.modwt2(x, wt, 1)
    for k, band in enumerate((lh, hl, hh, ll)):
        torch.testing.assert_close(got[k], band, rtol=0, atol=1e-13)


def test_integer_input_and_validation():
    wj, wt = jw.wavelet("Haar"), jt.wavelet("Haar")
    xi = np.arange(64 * 32).reshape(64, 32) % 7
    got = jt.modwt2(torch.from_numpy(xi), wt, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jw.modwt2(xi, wj, 2)),
                               atol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        jt.modwt2(torch.zeros(8, 64), wt, 4)
    with pytest.raises(ValueError, match="3·level\\+1"):
        jt.imodwt2(torch.zeros(5, 8, 8), wt)
    for fn in (lambda: jt.modwt2(torch.zeros(8, 8), wt, 1, method="fft"),
               lambda: jt.imodwt2(torch.zeros(4, 8, 8), wt, method="fft")):
        with pytest.raises(ValueError, match="unknown method"):
            fn()


# -- the gate --------------------------------------------------------------

def test_gate_on_cpu_pallas_raises_and_auto_is_plain():
    wt = jt.wavelet(DB4)
    x = torch.zeros(2, 64, 64)
    for fn in (lambda: jt.modwt2(x, wt, 2, method="pallas"),
               lambda: jt.imodwt2(torch.zeros(7, 2, 64, 64), wt,
                                  method="pallas")):
        with pytest.raises(ValueError, match="unavailable"):
            fn()
    before = [LAUNCHES["modwt2_fwd"], LAUNCHES["modwt2_inv"]]
    jt.imodwt2(jt.modwt2(x, wt, 2), wt)
    assert [LAUNCHES["modwt2_fwd"],
            LAUNCHES["modwt2_inv"]] == before


def test_requires_grad_takes_plain_path_and_matches_jax_grad():
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 40))
    wts = rng.standard_normal((7, 2, 24, 40))

    def loss_j(a):
        c = jw.modwt2(a, wj, 2, method="direct")
        return jnp.sum(c * wts) + jnp.sum(
            jw.imodwt2(c * c, wj, method="direct") ** 2)

    want = np.asarray(jax.jit(jax.grad(loss_j))(x))
    xt = _t(x).requires_grad_()
    c = jt.modwt2(xt, wt, 2)
    assert c.grad_fn is not None
    loss = (c * _t(wts)).sum() + (jt.imodwt2(c * c, wt) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-12)


# -- the kernels' plain versions against the JAX Pallas kernels ---------------

@pytest.mark.parametrize("shape", [(2, 128, 256), (2, 100, 500)])
def test_2d_plain_versions_match_jax_interpret(shape):
    x = np.random.default_rng(shape[2]).standard_normal(shape).astype(
        np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt2_fused(jnp.asarray(x), wj, 2,
                                       interpret=True))
    got = k2.modwt2_fused(_t(x), wt, 2)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    back_want = np.asarray(jax_imodwt2_fused(jnp.asarray(want), wj,
                                             interpret=True))
    back = k2.imodwt2_fused(_t(want), wt)
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=2e-5)


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_2d_denoise_plain_matches_jax_interpret(mode):
    x = np.random.default_rng(6).standard_normal((2, 64, 384)).astype(
        np.float32)
    thr = np.array([0.4, 0.9], np.float32)
    want = np.asarray(jax_denoise2_fused(jnp.asarray(x), jnp.asarray(thr),
                                         jw.wavelet(DB4), 2, mode,
                                         interpret=True))
    got = k2.modwt2_denoise_fused(_t(x), _t(thr), jt.wavelet(DB4), 2, mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_2d_plain_bf16_rounds_once():
    """bf16 in and out, f32 arithmetic: the f32 result rounded once."""
    x = _t(np.random.default_rng(7).standard_normal((2, 40, 56)).astype(
        np.float32)).bfloat16()
    w = jt.wavelet(DB4)
    c = k2.modwt2_fwd_plain(x, w, 2)
    assert c.dtype == torch.bfloat16
    assert torch.equal(c, k2.modwt2_fwd_plain(x.float(), w, 2).bfloat16())
    assert torch.equal(k2.modwt2_inv_plain(c, w),
                       k2.modwt2_inv_plain(c.float(), w).bfloat16())
    thr = torch.tensor([0.5, 0.8])
    assert torch.equal(k2.modwt2_denoise_plain(x, thr, w, 2),
                       k2.modwt2_denoise_plain(x.float(), thr, w,
                                               2).bfloat16())


def test_kernel2d_supported_budget():
    db4, sym8, haar = 8, 16, 2
    # Db4: forward and inverse to L4 (a strip of W = Tc + 49 columns at L3,
    # the whole 512-lane row of warps, one row a step), denoise L3
    assert k2.transform2_plan(3, db4, "fwd") == (512, 1, 512 - 49)
    assert k2.transform2_plan(3, db4, "inv") == (512, 1, 512 - 49)
    assert k2.transform2_plan(4, db4, "inv")[2] >= 8
    assert not k2.kernel2d_supported(4096, 4096, 5, db4, "fwd")
    # the denoise strip at Db4 L3: W = Tc + 2·49 columns, G rows a step
    w, grp, tc = k2.denoise2_plan(3, db4)
    assert w == tc + 2 * 49 and tc >= 40 and 1 <= grp <= 8
    assert not k2.kernel2d_supported(512, 512, 4, db4, "denoise")
    assert k2.kernel2d_supported(2, 40, 3, db4, "fwd")     # halo > image
    assert k2.kernel2d_supported(3, 2, 3, sym8, "inv")
    assert not k2.kernel2d_supported(512, 512, 4, sym8, "fwd")
    assert k2.kernel2d_supported(512, 512, 7, haar, "fwd")
    # both transforms' rings fit 227 KB, and one more window column does
    # not (or would leave the block's 16 warps of 32 columns a row); the
    # forward's Db4 L3 strip fits two blocks an SM
    assert 2 * (k2.transform2_smem_bytes(512, 1, 3, db4, "fwd") + 1024) \
        <= 233_472
    for level, m in ((3, db4), (4, db4), (3, sym8), (7, haar), (2, 44),
                     (1, 64)):
        for kind in ("fwd", "inv"):
            w, grp, tc = k2.transform2_plan(level, m, kind)
            assert k2.transform2_smem_bytes(w, grp, level, m, kind) \
                <= 232_448
            assert (k2.transform2_smem_bytes(w + 1, grp, level, m, kind)
                    > 232_448 or w == 32 * (16 // grp))
            assert tc == w - k2.halo(m, level) >= 8
    # the denoise's rings fit 227 KB, and one more window column does not
    # (or would leave the block's 16 warps of 32 columns a row)
    for level, m in ((3, db4), (2, sym8), (6, haar), (1, 64)):
        w, grp, tc = k2.denoise2_plan(level, m)
        assert k2.denoise2_smem_bytes(w, grp, level, m) <= 232_448
        assert (k2.denoise2_smem_bytes(w + 1, grp, level, m) > 232_448
                or w == 32 * (16 // grp))
        assert tc == w - 2 * k2.halo(m, level) >= 8


@pytest.mark.parametrize("level,m", [(3, 8), (2, 16), (6, 2), (1, 64),
                                     (2, 22), (5, 3)])
def test_denoise2_gate_admits_every_halo_to_65(level, m):
    """The fused denoise takes every (M, L) whose halo is at most 65;
    Db4 L4, Symlet 8 L3 and Haar L7 stay out."""
    assert k2.halo(m, level) <= 65
    assert k2.kernel2d_supported(2048, 2048, level, m, "denoise")
    assert k2.kernel2d_supported(3, 5, level, m, "denoise")  # halo > image
    assert not k2.kernel2d_supported(64, 64, level + 1, m, "denoise")


@pytest.mark.parametrize("level,m", [(4, 8), (3, 16), (7, 2), (2, 44),
                                     (6, 3), (1, 64), (3, 19), (5, 5)])
def test_transform2_gate_admits_every_halo_to_131(level, m):
    """The forward and inverse take every (M, L) whose halo is at most 131,
    as they always have (Db4 L4, Symlet 8 L3, Haar L7, M = 44 at L2), any
    R and C; the next level is refused."""
    assert k2.halo(m, level) <= 131
    for kind in ("fwd", "inv"):
        assert k2.kernel2d_supported(2048, 2048, level, m, kind)
        assert k2.kernel2d_supported(3, 5, level, m, kind)  # halo > image
        assert k2.transform2_plan(level, m, kind)[2] >= 8
        assert not k2.kernel2d_supported(64, 64, level + 1, m, kind)


def test_transform2_gate_is_the_halo_bound():
    """Over every filter length and level, the transforms' gate admits
    exactly the halos up to 131."""
    for m in range(1, 65):
        for level in range(1, 10):
            want = k2.halo(m, level) <= 131
            assert k2.kernel2d_supported(100, 100, level, m, "fwd") == want
            assert k2.kernel2d_supported(100, 100, level, m, "inv") == want


def test_transform2_rows_split_only_to_fill_the_card():
    """A transform work item warms up over H rows (the forward reads H rows
    up, the inverse H rows down), and the strips even out over C."""
    db4 = 8
    for kind in ("fwd", "inv"):
        tc = k2.transform2_strip(2048, 3, db4, kind)
        assert tc == 410 and 5 * tc >= 2048 > 4 * tc   # not 463, 463, ..., 196
        assert k2.transform2_strip(24, 3, db4, kind) == 24

        def cost(b, r, c, n, blocks=132):
            items = b * -(-c // tc) * -(-r // n)
            return -(-items // blocks) * (n + 49)

        for b, r in ((16, 2048), (1, 1024), (4, 512)):
            run = k2.transform2_run(b, r, 2048, 3, db4, 132, kind)
            assert 1 <= run <= r
            assert all(cost(b, r, 2048, run) <= cost(b, r, 2048, -(-r // n))
                       for n in range(1, min(r, 256) + 1))
        # as many strips as blocks: one run of all rows
        assert k2.transform2_run(132, 64, tc, 3, db4, 132, kind) == 64
        # one image on a whole card: short runs
        assert k2.transform2_run(1, 1000, 200, 3, db4, 132, kind) < 1000


def test_denoise2_rows_split_only_to_fill_the_card():
    """The run length is the one whose waves of work items, each n + 2H
    rows long, finish first on the card's blocks."""
    tc = k2.denoise2_plan(3, 8)[2]

    def cost(b, r, c, n, blocks=132):
        items = b * -(-c // tc) * -(-r // n)
        return -(-items // blocks) * (n + 2 * 49)

    for b, r, c in ((16, 2048, 2048), (1, 1024, 256), (1, 256, 256),
                    (4, 512, 512)):
        run = k2.denoise2_run(b, r, c, 3, 8, 132)
        assert 1 <= run <= r
        assert all(cost(b, r, c, run) <= cost(b, r, c, -(-r // n))
                   for n in range(1, min(r, 256) + 1))
    # as many strips as blocks: one run of all rows
    assert k2.denoise2_run(132, 64, tc, 3, 8, 132) == 64
    # one small image on a whole card: short runs
    assert k2.denoise2_run(1, 1024, 256, 3, 8, 132) < 1024
    # the delay rings: S_2 + G and S_3 + G rows at Db4 L3
    grp = k2.denoise2_plan(3, 8)[1]
    assert k2.denoise2_delay_rows(grp, 3, 8) == 42 + 28 + 2 * grp
    assert k2.denoise2_delay_rows(grp, 1, 8) == 0


def test_fused_wrappers_raise_on_unsupported_input():
    w = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="unsupported shape"):
        k2.modwt2_fused(torch.zeros(64, 64), w, 5)
    with pytest.raises(ValueError, match="unsupported shape"):
        k2.modwt2_denoise_fused(torch.zeros(64, 64), torch.ones(1), w, 4)
    with pytest.raises(ValueError):
        k2.modwt2_fused(torch.zeros(2, 2, 64, 64), w, 2)
    with pytest.raises(ValueError, match="3L\\+1"):
        k2.imodwt2_fused(torch.zeros(5, 64, 64), w)
    for launch in (lambda: k2.modwt2_fwd_cuda(torch.zeros(2, 64, 64), w, 2),
                   lambda: k2.modwt2_inv_cuda(torch.zeros(7, 2, 64, 64), w),
                   lambda: k2.modwt2_denoise_cuda(
                       torch.zeros(2, 64, 64), torch.ones(2), w, 2)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch()
    # (R, C) runs as B = 1
    x = _t(np.random.default_rng(8).standard_normal((48, 40)))
    torch.testing.assert_close(k2.modwt2_fused(x, w, 2),
                               k2.modwt2_fused(x[None], w, 2)[:, 0])
    torch.testing.assert_close(
        k2.modwt2_denoise_fused(x, torch.tensor([0.5]), w, 2),
        k2.modwt2_denoise_fused(x[None], torch.tensor([0.5]), w, 2)[0])


# -- modwt2_denoise ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("rule", [None, "universal", "sure", "bayes", 0.7])
def test_modwt2_denoise_matches_jax_f64(rule, mode):
    x = np.random.default_rng(9).standard_normal((2, 32, 48))
    want = np.asarray(_jax_denoise(2, mode, rule)(x))
    got = jt.modwt2_denoise(_t(x), jt.wavelet(DB4), 2, mode, threshold=rule)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_pipeline_per_image_threshold_matches_jax_b11():
    """A (B,) array is per image: the port's pipeline equals the JAX
    pipeline given the JAX-safe (B, 1, 1) shape."""
    x = np.random.default_rng(10).standard_normal((3, 24, 40))
    thr = np.array([0.3, 0.6, 1.2])
    want = np.asarray(_jax_denoise(2, "soft", None)(x, thr[:, None, None]))
    w = jt.wavelet(DB4)
    for t in (thr, _t(thr), thr[:, None, None]):
        got = jt.modwt2_denoise(_t(x), w, 2, threshold=t)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_pipeline_numpy_threshold_keeps_float32():
    """A float64 NumPy (B,) threshold does not promote float32 images: the
    result stays float32 and equals the float32 tensor threshold's."""
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (3, 24, 40)).astype(np.float32))
    thr = np.array([0.3, 0.6, 1.2])
    w = jt.wavelet(DB4)
    got = jt.modwt2_denoise(x, w, 2, threshold=thr)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, jt.modwt2_denoise(x, w, 2, threshold=torch.tensor(
            thr, dtype=torch.float32)), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_per_image_threshold_contract_fused_equals_auto(mode):
    """B == C: the (B,) array still means one threshold per image under
    'fused' and 'auto' alike (JAX's pipeline would scale per column)."""
    x = _t(np.random.default_rng(11).standard_normal((8, 16, 8)))
    thr = torch.linspace(0.25, 2.0, 8, dtype=torch.float64)  # f32-exact
    w = jt.wavelet(DB4)
    fused = jt.modwt2_denoise(x, w, 2, mode, threshold=thr, method="fused")
    auto = jt.modwt2_denoise(x, w, 2, mode, threshold=thr, method="auto")
    per_image = torch.stack([jt.modwt2_denoise(x[b], w, 2, mode,
                                               threshold=float(thr[b]))
                             for b in range(8)])
    torch.testing.assert_close(fused, auto, rtol=0, atol=1e-12)
    torch.testing.assert_close(auto, per_image, rtol=0, atol=1e-12)


@pytest.mark.parametrize("threshold", [None, 0.8, np.array([0.5, 1.0])])
def test_modwt2_denoise_fused_matches_jax(threshold):
    x = np.random.default_rng(12).standard_normal((2, 64, 384)).astype(
        np.float32)
    want = np.asarray(jw.modwt2_denoise(x, jw.wavelet(DB4), 2,
                                        threshold=threshold, method="fused"))
    got = jt.modwt2_denoise(_t(x), jt.wavelet(DB4), 2, threshold=threshold,
                            method="fused")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_fused_rejects_rules_and_shapes_like_jax():
    x = np.zeros((2, 64, 64))
    for rule in ("sure", "bayes"):
        for pkg, w in ((jt, jt.wavelet(DB4)), (jw, jw.wavelet(DB4))):
            with pytest.raises(ValueError, match="scalar-per-image"):
                pkg.modwt2_denoise(x if pkg is jw else _t(x), w, 2,
                                   threshold=rule, method="fused")
    w = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="supports"):
        jt.modwt2_denoise(torch.zeros(2, 2, 32, 32), w, 2, method="fused")
    with pytest.raises(ValueError, match="unknown method"):
        jt.modwt2_denoise(_t(x), w, 2, method="pallas")
    with pytest.raises(ValueError, match="unknown threshold rule"):
        jt.modwt2_denoise(_t(x), w, 2, threshold="nope")
    # an (R, C) image takes the fused path as B = 1
    xi = _t(np.random.default_rng(13).standard_normal((32, 48)))
    torch.testing.assert_close(
        jt.modwt2_denoise(xi, w, 2, method="fused", threshold=0.5),
        jt.modwt2_denoise(xi[None], w, 2, method="fused", threshold=0.5)[0])


def test_modwt2_denoise_reduces_mse():
    rng = np.random.default_rng(14)
    r = np.arange(64)[:, None]
    c = np.arange(64)[None, :]
    clean = np.sign(np.sin(2 * np.pi * r / 32)) * np.cos(2 * np.pi * c / 64)
    noisy = clean + 0.3 * rng.normal(size=(64, 64))
    for method in ("auto", "fused"):
        out = jt.modwt2_denoise(_t(noisy), jt.wavelet(DB4), 2,
                                method=method).numpy()
        assert np.mean((out - clean) ** 2) < 0.5 * np.mean(
            (noisy - clean) ** 2), method
