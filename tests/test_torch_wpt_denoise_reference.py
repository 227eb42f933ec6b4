"""The port's best-basis packet denoise against the benchmark's plain float64
reference (``wavebench/reference/wpt.py``), on the CPU, and the reference
alone.

Tolerances:

* float64, 1e-10 of the largest reference value, leaf masks equal: the
  port and the reference run the same filter-bank sums in float64 by
  different routes (banded products against rolls), and the reference's
  Symlet 8 taps, factorised anew, differ from the port's published ones
  by 9·10⁻¹³; twelve steps move a value by some 10⁻¹¹ of the largest.  No
  SURE margin of these random signals lies that close to a tie.
* float32, under the check's own rule and limit (``error``, the cell's
  ``wpt_err`` limit): the nearest of the bases the float32 rounding
  leaves open, and at most ``MAX_BASES`` of them.  bfloat16 must fail it.
* the reference's inverse step of its forward step, 1e-12: the taps are
  orthonormal under double shifts to 10⁻¹⁶.
"""
import importlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from wavebench.reference import wpt as ref

wpt_ops = importlib.import_module("jwave_pro_tpu_torch.ops.wpt")

SYM8 = jt.wavelet("Symlet 8")
ROOT = Path(__file__).resolve().parents[1]
LIMIT = json.loads((ROOT / "wavebench" / "workloads"
                    / "wpt_sym8_l6.denoise.json").read_text()
                   )["check"]["limits"]["wpt_err"]
# (shape, level): the full depth of a short signal, a shallower tree
SHAPES = [((3, 4096), 6), ((2, 8192), 4)]


def _signal(shape, seed, dtype=torch.float64):
    return torch.from_numpy(3.0 * np.random.default_rng(seed)
                            .standard_normal(shape)).to(dtype)


def test_the_taps_are_an_orthonormal_symlet_8():
    g = np.array(ref.SYMLET_8[0])
    f = np.array(ref.SYMLET_8[1])
    assert len(g) == len(f) == 16
    assert g.sum() == pytest.approx(math.sqrt(2.0), abs=1e-14)
    for m in range(8):                       # double-shift orthonormality
        want = 1.0 if m == 0 else 0.0
        assert np.dot(g[:16 - 2 * m], g[2 * m:]) == pytest.approx(
            want, abs=1e-14)
        assert np.dot(f[:16 - 2 * m], f[2 * m:]) == pytest.approx(
            want, abs=1e-14)
        assert abs(np.dot(g[:16 - 2 * m], f[2 * m:])) < 1e-14
        assert abs(np.dot(f[:16 - 2 * m], g[2 * m:])) < 1e-14
    k = np.arange(16, dtype=np.float64)
    for p in range(8):                       # eight vanishing moments
        terms = k ** p * f
        assert abs(terms.sum()) <= 1e-13 * np.abs(terms).sum()
    # and not a ninth
    assert abs((k ** 8 * f).sum()) > 1e-6 * np.abs(k ** 8 * f).sum()
    # the port's published taps, to their own accuracy
    np.testing.assert_allclose(g, SYM8.dec_lo, rtol=0, atol=1e-12)
    np.testing.assert_allclose(f, SYM8.dec_hi, rtol=0, atol=1e-12)


def test_the_inverse_step_undoes_the_step():
    x = _signal((3, 4, 64), seed=1)
    y = ref.step(x, ref.SYMLET_8)
    torch.testing.assert_close(ref.unstep(y, ref.SYMLET_8), x, rtol=0,
                               atol=1e-12)
    # the step is JWave's: lo[i] = Σ_j x[(2i + j) mod h]·g[j]
    g = ref.SYMLET_8[0]
    h = x.shape[-1]
    lo = [sum(float(x[1, 2, (2 * i + j) % h]) * g[j] for j in range(16))
          for i in range(h // 2)]
    np.testing.assert_allclose(y[1, 2, :h // 2].numpy(), lo, rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("per_sample", [True, False])
@pytest.mark.parametrize("shape,level", SHAPES)
def test_f64_matches_the_reference(shape, level, per_sample, mode):
    x = _signal(shape, seed=sum(shape) + level)
    got = jt.wpt_denoise(x, SYM8, level, mode=mode, per_sample=per_sample)
    want, masks = ref.denoise(x, ref.SYMLET_8, level, mode, per_sample)
    port, _, _ = jt.best_basis(x, SYM8, level, "sure", per_sample=per_sample)
    assert len(port) == len(masks) == level + 1
    for a, b in zip(port, masks):
        assert torch.equal(a.expand_as(b), b)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-10


@pytest.mark.parametrize("per_sample", [True, False])
@pytest.mark.parametrize("shape,level", SHAPES)
def test_f32_passes_the_check(shape, level, per_sample):
    x = _signal(shape, seed=7 * sum(shape) + level, dtype=torch.float32)
    got = jt.wpt_denoise(x, SYM8, level, per_sample=per_sample)
    err, bases, opened = ref.error(got, x, ref.SYMLET_8, level, "soft",
                                   per_sample)
    assert err <= LIMIT and 1 <= bases <= ref.MAX_BASES, (err, bases)
    assert 0 <= opened


@pytest.mark.parametrize("shape,level", SHAPES)
def test_bf16_fails_the_check(shape, level):
    x = _signal(shape, seed=11 * sum(shape) + level, dtype=torch.float32)
    got = jt.wpt_denoise(x.bfloat16(), SYM8, level, per_sample=True)
    err, _, _ = ref.error(got.float(), x, ref.SYMLET_8, level)
    assert err > LIMIT


def test_the_reference_sure_is_the_ports():
    c = _signal((5, 300), seed=3)
    torch.testing.assert_close(ref.sure(c), wpt_ops.sure_cost(c), rtol=0,
                               atol=1e-9)
