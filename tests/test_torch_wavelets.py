"""The port's wavelet registry against the JAX package's.

A wavelet's parameters are its four filter banks, so the banks must be
equal EXACTLY (both packages build them from the same ``_taps.py`` with
the same float64 arithmetic): any difference would make every transform
comparison downstream meaningless.
"""
import numpy as np
import pytest
import torch

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt

BANKS = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")
META = ("name", "transform_wavelength", "energy_correction", "family")
ALL_NAMES = jw.wavelet_names(include_rejected=True)


def test_registry_has_all_67_entries():
    assert len(ALL_NAMES) == 67
    assert jt.wavelet_names(include_rejected=True) == ALL_NAMES
    assert jt.wavelet_names() == jw.wavelet_names()
    assert [w.name for w in jt.good_wavelets()] == \
        [w.name for w in jw.good_wavelets()]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_banks_equal_jax_exactly(name):
    want = jw.wavelet(name, unsafe=True)
    got = jt.wavelet(name, unsafe=True)
    for f in BANKS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{name} {f}")
        assert getattr(got, f).dtype == np.float64
    for f in META:
        assert getattr(got, f) == getattr(want, f), (name, f)
    assert got.length == want.length
    # the weights carried across: from_jax_wavelet builds the same object
    carried = jt.from_jax_wavelet(want)
    assert carried == got and hash(carried) == hash(got)
    for f in META:
        assert getattr(carried, f) == getattr(want, f)


@pytest.mark.parametrize("alias,name", [
    ("db4", "Daubechies 4"), ("db1", "Haar"), ("sym8", "Symlet 8"),
    ("coif2", "Coiflet 2"), ("bior3.5", "BiOrthogonal 3/5"),
    ("dmey", "Discrete Meyer"), ("HAAR", "Haar"), ("leg2", "Legendre 2"),
])
def test_aliases(alias, name):
    assert jt.wavelet(alias).name == jw.wavelet(alias).name == name


@pytest.mark.parametrize("name", ["Battle 23", "CDF 5/3", "CDF 9/7"])
def test_builder_rejected_need_unsafe(name):
    with pytest.raises(ValueError) as jax_err:
        jw.wavelet(name)
    with pytest.raises(ValueError) as port_err:
        jt.wavelet(name)
    assert str(port_err.value) == str(jax_err.value)
    assert jt.wavelet(name, unsafe=True).name == name


def test_unknown_name_raises_not_known():
    with pytest.raises(jt.NotKnown):
        jt.wavelet("Daubechies 99")
    assert issubclass(jt.NotKnown, jt.JWaveFailure)
    assert issubclass(jt.JWaveFailure, ValueError)


def test_family_helpers():
    assert jt.daubechies(1).name == "Haar"
    assert jt.daubechies(4).name == "Daubechies 4"
    assert jt.symlet(8).name == "Symlet 8"
    assert jt.coiflet(3).name == "Coiflet 3"
    assert jt.biorthogonal(3, 5).name == "BiOrthogonal 3/5"
    assert jt.legendre(2).name == "Legendre 2"
    w = jt.wavelet("db4")
    assert jt.wavelet(w) is w


def test_qmf_builders_match_jax():
    from jwave_pro_tpu.wavelets.base import (
        qmf_biorthogonal as jb, qmf_orthonormal as jo)

    lo = np.array([0.1, 0.4, 0.7, 0.2])
    hi = np.array([-0.3, 0.5, 0.25, -0.1])
    for port, ref in ((jt.qmf_orthonormal("t", lo), jo("t", lo)),
                      (jt.qmf_biorthogonal("t", lo, hi), jb("t", lo, hi))):
        for f in BANKS:
            np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))


def test_tensor_banks_cached_per_device_and_dtype():
    w = jt.wavelet("Symlet 8")
    f64 = w.tensor_banks("cpu", torch.float64)
    assert w.tensor_banks("cpu", torch.float64) is f64
    f32 = w.tensor_banks("cpu", torch.float32)
    assert f32 is not f64 and f32[0].dtype == torch.float32
    for t, f in zip(f64, BANKS):
        np.testing.assert_array_equal(t.numpy(), getattr(w, f))


def test_taps_loaded_by_path_not_by_import():
    import sys

    from jwave_pro_tpu_torch.wavelets import families

    assert families._TAPS_FILE.name == "_taps.py"
    assert "jwave_pro_tpu_torch.wavelets._taps" not in sys.modules
