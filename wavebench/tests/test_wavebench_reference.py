"""The plain reference: a Haar case worked by hand, its frozen filters, and
its agreement with the port at small sizes on the CPU."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch.ops.modwt import modwt_base_filters
from wavebench.reference import compare, filters
from wavebench.reference import cwt as rcwt
from wavebench.reference import modwt as ref


def test_haar_by_hand():
    # x = [1, 2, 3, 4]; level 1: W[n] = (x[n] − x[n−1])/2,
    # V[n] = (x[n] + x[n−1])/2, circularly; level 2 reads two back
    x = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    c = ref.modwt(x, filters.HAAR, 2)
    w1 = [(1 - 4) / 2, (2 - 1) / 2, (3 - 2) / 2, (4 - 3) / 2]
    v1 = [(1 + 4) / 2, (2 + 1) / 2, (3 + 2) / 2, (4 + 3) / 2]
    w2 = [(v1[n] - v1[n - 2]) / 2 for n in range(4)]
    v2 = [(v1[n] + v1[n - 2]) / 2 for n in range(4)]
    assert c.tolist() == [w1, w2, v2]
    assert torch.allclose(ref.imodwt(c, filters.HAAR), x, atol=1e-15)


def test_haar_median_and_denoise_by_hand():
    assert ref.median(torch.tensor([[4.0, 1.0, 3.0, 2.0]])).tolist() == [
        2.5]
    # a constant signal has W = 0, σ = 0, nothing to shrink: it comes back
    x = torch.full((2, 16), 3.0, dtype=torch.float64)
    assert torch.allclose(ref.denoise(x, filters.HAAR, 2), x, atol=1e-15)


@pytest.mark.parametrize("name", sorted(filters.BY_NAME))
def test_frozen_filters_are_the_ports(name):
    g, h = modwt_base_filters(jt.wavelet(name))
    fg, fh = filters.BY_NAME[name]
    np.testing.assert_allclose(fg, g, rtol=0, atol=1e-16)
    np.testing.assert_allclose(fh, h, rtol=0, atol=1e-16)


def signal(rows, n, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, n))).float()


@pytest.mark.parametrize("n", [1000, 1031])
def test_modwt_and_denoise_agree_with_the_port(n):
    x = signal(3, n)
    db4 = filters.DAUBECHIES_4
    w = jt.wavelet("Daubechies 4")
    assert compare.rel_err(jt.modwt(x, w, 5), ref.modwt(x, db4, 5)) < 1e-6
    assert compare.rel_err(jt.modwt_denoise(x, w, 5),
                           ref.denoise(x, db4, 5)) < 1e-5
    c = ref.modwt(x, db4, 5)
    assert compare.rel_err(ref.imodwt(c, db4), x) < 1e-12


def test_cwt_agrees_with_the_port():
    x = signal(2, 1000)
    scales = rcwt.log_scales(1.0, 256.0, 16)
    got = jt.cwt(x, scales, jt.MorletWavelet.from_omega0(6.0)).coefficients
    want = rcwt.cwt(x, scales, 6.0)
    assert got.shape == want.shape == (2, 16, 1000)
    assert compare.rel_err(got, want) < 1e-5
    np.testing.assert_allclose(scales, jt.generate_log_scales(1.0, 256.0,
                                                              16))


def test_causal_tail_is_the_streams_matrix():
    from jwave_pro_tpu_torch import streaming

    db4 = filters.DAUBECHIES_4
    chunks = np.random.default_rng(9).standard_normal(
        (6, 256)).astype(np.float32)
    stream = streaming.StreamingMODWT(jt.wavelet("Daubechies 4"),
                                      streaming.StreamingConfig(
                                          buffer_size=512, max_level=3,
                                          device="cpu"))
    for chunk in chunks:
        out = stream.update(chunk)
    want = ref.causal_tail(torch.from_numpy(chunks.reshape(-1)), db4, 3,
                           512)
    assert want.shape == out.shape == (4, 512)
    assert compare.rel_err(out, want) < 1e-6
    with pytest.raises(ValueError):
        ref.causal_tail(torch.zeros(100), db4, 3, 512)


def test_rel_err_by_rows_is_the_whole():
    want = torch.randn(3, 10, 7, dtype=torch.float64)
    got = want + 1e-3 * torch.randn(3, 10, 7, dtype=torch.float64)
    whole = compare.rel_err(got, want)
    rows = compare.rel_err_rows(got, lambda i, j: want[:, i:j], 10,
                                axis=1, block=3)
    assert rows == pytest.approx(whole, rel=1e-12)
    assert math.isfinite(whole) and whole > 0
