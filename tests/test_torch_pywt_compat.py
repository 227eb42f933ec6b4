"""The port's PyWavelets-style coefficient lists (``ops/pywt_compat.py``)
against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages; the JAX calls
run under ``jax.jit``.  Tolerances: f64 values 1e-12 × max(1, max|ref|)
(the same float64 steps in another summation order), f64 round trips
1e-8; shapes, list lengths and octant keys exactly equal; the errors of
the same kind with the same message.
"""
import functools

import numpy as np
import pytest
import torch

import jax

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

DB4 = "Daubechies 4"


@functools.lru_cache(maxsize=None)
def _jax(fn, *static):
    return jax.jit(lambda x: getattr(jw, fn)(x, *static))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-12, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _pair(name=DB4):
    return jw.wavelet(name), jt.wavelet(name)


@pytest.mark.parametrize("name", [DB4, "Haar orthogonal", "Symlet 8"])
@pytest.mark.parametrize("n", [64, 300, 512])
def test_dwt_idwt_match_jax(name, n):
    wj, wt = _pair(name)
    x = np.random.default_rng(n).standard_normal((2, n))
    ca, cd = _jax("dwt", wj)(x)
    got_a, got_d = jt.dwt(_t(x), wt)
    _close(got_a, ca, what="cA")
    _close(got_d, cd, what="cD")
    back = jt.idwt(got_a, got_d, wt)
    _close(back, jax.jit(lambda a, d: jw.idwt(a, d, wj))(ca, cd),
           what="idwt")
    _close(back, x, 1e-8, "round trip")


@pytest.mark.parametrize("level", [None, 1, 4])
def test_wavedec_waverec_and_flat_lists_match_jax(level):
    wj, wt = _pair()
    x = np.random.default_rng(1).standard_normal((3, 1024))
    want = _jax("wavedec", wj, level)(x)
    got = jt.wavedec(_t(x), wt, level)
    assert len(got) == len(want) == (10 if level is None else level) + 1
    for g, w in zip(got, want):
        _close(g, w, what="coefficient")
    back = jt.waverec(got, wt)
    _close(back, jax.jit(lambda c: jw.waverec(c, wj))(want), what="waverec")
    _close(back, x, 1e-8, "round trip")
    flat = jt.coeffs_to_flat(got)
    _close(flat, jw.coeffs_to_flat(want), what="coeffs_to_flat")
    lvl = len(got) - 1
    for g, w in zip(jt.flat_to_coeffs(flat, lvl),
                    jw.flat_to_coeffs(np.asarray(flat), lvl)):
        _close(g, w, what="flat_to_coeffs")


@pytest.mark.parametrize("shape", [(2, 32, 64), (16, 24)])
def test_dwt2_wavedec2_match_jax(shape):
    wj, wt = _pair()
    x = np.random.default_rng(2).standard_normal(shape)
    ca, dets = _jax("dwt2", wj)(x)
    got_a, got_d = jt.dwt2(_t(x), wt)
    _close(got_a, ca, what="cA")
    for g, w in zip(got_d, dets):
        _close(g, w, what="detail")
    back = jt.idwt2(got_a, got_d, wt)
    _close(back, x, 1e-8, "dwt2 round trip")
    want = _jax("wavedec2", wj, None)(x)
    got = jt.wavedec2(_t(x), wt)
    assert len(got) == len(want)
    _close(got[0], want[0], what="cA_L")
    for gd, wd in zip(got[1:], want[1:]):
        for g, w in zip(gd, wd):
            _close(g, w, what="wavedec2 detail")
    back = jt.waverec2(got, wt)
    _close(back, jax.jit(lambda c: jw.waverec2(c, wj))(want),
           what="waverec2")
    _close(back, x, 1e-8, "wavedec2 round trip")


def test_dwt3_wavedec3_match_jax():
    wj, wt = _pair("Symlet 8")
    x = np.random.default_rng(3).standard_normal((2, 8, 16, 32))
    caaa, dets = _jax("dwt3", wj)(x)
    got_a, got_d = jt.dwt3(_t(x), wt)
    _close(got_a, caaa, what="cAAA")
    assert sorted(got_d) == sorted(dets)
    for k in dets:
        _close(got_d[k], dets[k], what=k)
    _close(jt.idwt3(got_a, got_d, wt), x, 1e-8, "dwt3 round trip")
    for level in (None, 2):
        want = _jax("wavedec3", wj, level)(x)
        got = jt.wavedec3(_t(x), wt, level)
        assert len(got) == len(want)
        _close(got[0], want[0], what="cAAA_L")
        for gd, wd in zip(got[1:], want[1:]):
            for k in wd:
                _close(gd[k], wd[k], what=k)
        back = jt.waverec3(got, wt)
        _close(back, jax.jit(lambda c: jw.waverec3(c, wj))(want),
               what="waverec3")
        _close(back, x, 1e-8, "wavedec3 round trip")


def test_default_depth_respects_the_transform_wavelength():
    taps = jw.wavelet(DB4).dec_lo
    wj = jw.qmf_orthonormal("TWL8", taps, transform_wavelength=8)
    wt = jt.qmf_orthonormal("TWL8", taps, transform_wavelength=8)
    x = np.random.default_rng(4).standard_normal((32, 64))
    assert len(jt.wavedec2(_t(x), wt)) == len(jw.wavedec2(x, wj)) == 4
    v = np.random.default_rng(5).standard_normal((16, 32, 64))
    assert len(jt.wavedec3(_t(v), wt)) == len(jw.wavedec3(v, wj)) == 3


def _same_error(jax_call, port_call):
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    with pytest.raises(ValueError) as port_err:
        port_call()
    assert str(port_err.value) == str(jax_err.value)


def test_errors_match_jax():
    wj, wt = _pair()
    odd = np.zeros((2, 7))
    _same_error(lambda: jw.dwt(odd, wj), lambda: jt.dwt(_t(odd), wt))
    a, b = np.zeros(4), np.zeros(5)
    _same_error(lambda: jw.idwt(a, b, wj), lambda: jt.idwt(_t(a), _t(b), wt))
    img = np.zeros((6, 5))
    _same_error(lambda: jw.dwt2(img, wj), lambda: jt.dwt2(_t(img), wt))
    ca, cd = np.zeros((2, 3)), np.zeros((2, 4))
    _same_error(lambda: jw.idwt2(ca, (ca, cd, ca), wj),
                lambda: jt.idwt2(_t(ca), (_t(ca), _t(cd), _t(ca)), wt))
    vol = np.zeros((4, 4, 3))
    _same_error(lambda: jw.dwt3(vol, wj), lambda: jt.dwt3(_t(vol), wt))
    c = np.zeros((2, 2, 2))
    part = {k: c for k in ("aad", "ada")}
    _same_error(lambda: jw.idwt3(c, part, wj),
                lambda: jt.idwt3(_t(c), {k: _t(v) for k, v in part.items()},
                                 wt))
    _same_error(lambda: jw.wavedec2(img[:4, :4], wj, 0),
                lambda: jt.wavedec2(_t(img[:4, :4]), wt, 0))
    _same_error(lambda: jw.wavedec3(vol[:2, :2, :2], wj, 0),
                lambda: jt.wavedec3(_t(vol[:2, :2, :2]), wt, 0))
