"""The port's 2D denoise against the benchmark's plain float64 reference
(``wavebench/reference/modwt2.py``), on the CPU, and the reference alone.

The reference's transform and inverse carry every case; its ``denoise``
is the universal soft rule the benchmark's cell runs, and the SURE and
Bayes thresholds and the hard shrink are written out here from their
definitions, band by band, apart from the port's code.

Tolerances:

* float64, 1e-12 absolute: the port and the reference run the same
  rolls and multiply-adds in float64; no random coefficient sits within
  rounding of a threshold, so neither shrink turns on the last bits.
* float32, soft, 1e-5 of the largest reference value: the port's float32
  cascade rounds each of its 2·M·L multiply-adds a value (M = 8 taps,
  L ≤ 3 levels; ε₃₂ = 6·10⁻⁸, so ~3·10⁻⁶ of the largest coefficient),
  the threshold's median is of rounded values, and the soft shrink moves
  by no more than its input and its threshold do.  A hard shrink jumps
  where a coefficient lies within rounding of the threshold, so a float32
  hard case proves nothing; SURE picks its threshold by an arg-min over
  the sorted values, which rounding may move to a neighbouring value, so
  it is held in float64 alone.  bfloat16 (ε = 3.9·10⁻³) must fail the
  bound.
* the reference's inverse of its forward, 1e-10: the frozen taps are
  orthonormal under shifts only to ~10⁻¹² (the 1D reference reconstructs
  to the same).

The default path's answers are pinned bitwise to the inline formula the
2D and 3D denoisers ran before they took the 1D denoiser's threshold and
shrink helpers (``_inline2``, ``_inline3``).
"""
import math

import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from wavebench.reference import filters
from wavebench.reference import modwt2 as ref
from wavebench.reference.modwt import median

DB4 = jt.wavelet("Daubechies 4")
TAPS = filters.DAUBECHIES_4
# (shape, level): square, non-square, odd sides, batched and not
SHAPES = [((48, 48), 3), ((37, 53), 2), ((2, 37, 53), 3), ((3, 40, 24), 1),
          ((2, 17, 31), 2)]
RULES = ["universal", "sure", "bayes", "number", "per_image"]
F32_TOL = 1e-5


def _images(shape, seed, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).to(dtype)


def _stack(x):
    """(B, R, C) view of an image or a stack."""
    return x[None] if x.ndim == 2 else x


def _sure(d, sigma):
    """SureShrink's hybrid threshold of one band ``d`` (flat), from its
    definition: the candidate t = |y|_k minimising n − 2·#{|y| ≤ t} +
    Σ min(|y|, t)², the first on ties, y = d/σ; the universal √(2·ln n)
    where the band's energy (Σy² − n)/n is at most log₂(n)^{3/2}/√n, and
    at most it elsewhere."""
    n = d.numel()
    y = torch.sort((d / sigma).abs()).values
    # at t = y[k]: #{|y| ≤ t} by a search of the sorted values, and
    # Σ min(|y|, t)² as the squares up to t plus t² for each value past it
    below = torch.searchsorted(y, y, right=True)
    squares = torch.cat([y.new_zeros(1), torch.cumsum(y * y, 0)])
    risks = n - 2.0 * below + squares[below] + (n - below) * y * y
    t_sure = y[int(torch.argmin(risks))]
    t_univ = math.sqrt(2.0 * math.log(n))
    energy = ((y * y).sum() - n) / n
    if energy <= math.log2(n) ** 1.5 / math.sqrt(n):
        return t_univ * sigma
    return min(float(t_sure), t_univ) * sigma


def _bayes(d, sigma):
    """BayesShrink's σ²/σ_x of one band, σ_x = √max(mean(d²) − σ², 0), or
    max|d| where σ_x = 0."""
    sig_x = math.sqrt(max(float((d * d).mean()) - sigma ** 2, 0.0))
    return sigma ** 2 / sig_x if sig_x > 0 else float(d.abs().max())


def _expected(x, level, rule, mode, threshold=None):
    """The denoise of each image of ``x`` from the reference's transform,
    float64."""
    out = []
    for b, image in enumerate(_stack(x.double())):
        bands = ref.modwt2(image, TAPS, level)
        details = bands[:3 * level]
        sigma = float(median(bands[2].abs().reshape(-1))) / 0.6745
        if rule == "universal":
            t = torch.full((3 * level, 1, 1), float(ref.threshold(bands[2])),
                           dtype=torch.float64)
        elif rule in ("sure", "bayes"):
            pick = _sure if rule == "sure" else _bayes
            t = torch.tensor([pick(d.reshape(-1), sigma) for d in details],
                             dtype=torch.float64)[:, None, None]
        elif rule == "number":
            t = torch.full((3 * level, 1, 1), threshold, dtype=torch.float64)
        else:
            t = torch.full((3 * level, 1, 1), float(threshold[b]),
                           dtype=torch.float64)
        if mode == "soft":
            shrunk = torch.sign(details) * torch.clamp_min(
                details.abs() - t, 0.0)
        else:
            shrunk = torch.where(details.abs() > t, details, 0.0)
        out.append(ref.imodwt2(torch.cat([shrunk, bands[3 * level:]]), TAPS))
    out = torch.stack(out)
    return out[0] if x.ndim == 2 else out


def _threshold_arg(rule, x):
    """The port's ``threshold`` argument for ``rule`` and what the
    expectation takes for it."""
    if rule in ("universal", "sure", "bayes"):
        return rule, None
    if rule == "number":
        return 0.7, 0.7
    t = np.linspace(0.4, 1.1, _stack(x).shape[0])
    return t, t


def _cases(rules):
    """(shape, level, rule) for every shape and rule; a per-image array
    only with a (B, R, C) stack."""
    return [(shape, level, rule) for shape, level in SHAPES for rule in rules
            if rule != "per_image" or len(shape) == 3]


def _port(x, level, rule, mode):
    arg, value = _threshold_arg(rule, x)
    return jt.modwt2_denoise(x, DB4, level, mode=mode, threshold=arg), value


# -- the port against the reference --------------------------------------------

@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("shape,level,rule", _cases(RULES))
def test_f64_matches_the_reference(shape, level, rule, mode):
    x = _images(shape, seed=sum(shape) + level)
    got, value = _port(x, level, rule, mode)
    want = _expected(x, level, rule, mode, value)
    assert got.dtype == torch.float64 and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape,level,rule", _cases(
    ["universal", "bayes", "number", "per_image"]))
def test_f32_soft_within_rounding_of_the_reference(shape, level, rule):
    x = _images(shape, seed=7 * sum(shape) + level, dtype=torch.float32)
    got, value = _port(x, level, rule, "soft")
    want = _expected(x, level, rule, "soft", value)
    assert got.dtype == torch.float32
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err <= F32_TOL, err


@pytest.mark.parametrize("shape,level", SHAPES[2:4])
def test_bf16_fails_the_f32_bound(shape, level):
    x = _images(shape, seed=11 * sum(shape), dtype=torch.bfloat16)
    got = jt.modwt2_denoise(x, DB4, level)
    want = ref.denoise_images(_stack(x.double()), TAPS, level).reshape(
        x.shape)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err > 10 * F32_TOL, err


def test_the_reference_denoise_is_the_universal_soft_rule():
    x = _images((2, 37, 53), seed=5)
    torch.testing.assert_close(ref.denoise_images(x, TAPS, 3),
                               _expected(x, 3, "universal", "soft"),
                               rtol=0, atol=0)


# -- the reference alone ---------------------------------------------------------

@pytest.mark.parametrize("shape,level", [((48, 48), 3), ((37, 53), 2),
                                         ((16, 64), 4), ((9, 7), 1)])
def test_reference_inverse_reconstructs(shape, level):
    x = _images(shape, seed=level)
    bands = ref.modwt2(x, TAPS, level)
    assert bands.shape == (3 * level + 1,) + shape
    torch.testing.assert_close(ref.imodwt2(bands, TAPS), x, rtol=0,
                               atol=1e-10)


def _direct_2d(x, down, along):
    """Σ_k Σ_l down[k]·along[l]·x[(r − k) mod R, (c − l) mod C]: the level-1
    band of filter ``down`` over r and ``along`` over c as one 2D circular
    convolution."""
    out = torch.zeros_like(x)
    for k, a in enumerate(down):
        for m, b in enumerate(along):
            out += a * b * torch.roll(x, (k, m), dims=(0, 1))
    return out


@pytest.mark.parametrize("band", ["LH", "HL", "HH", "LL"])
@pytest.mark.parametrize("shape", [(37, 53), (24, 24)])
def test_reference_level1_bands_are_2d_circular_convolutions(shape, band):
    x = _images(shape, seed=3)
    g, h = TAPS
    pick = {"L": g, "H": h}
    got = ref.modwt2(x, TAPS, 1)[["LH", "HL", "HH", "LL"].index(band)]
    torch.testing.assert_close(got, _direct_2d(x, pick[band[0]],
                                               pick[band[1]]),
                               rtol=0, atol=1e-13)


def test_reference_band_order_is_the_ports():
    x = _images((2, 40, 24), seed=9)
    for level in (1, 2, 3):
        want = torch.stack([ref.modwt2(im, TAPS, level) for im in x], 1)
        torch.testing.assert_close(jt.modwt2(x, DB4, level, method="direct"),
                                   want, rtol=0, atol=1e-12)


# -- the default path, bitwise as before -------------------------------------------

def _inline2(x, level, mode, threshold):
    """The 2D default pipeline as it ran inline before it called
    ``_rule_threshold`` and ``_shrunk``."""
    from jwave_pro_tpu_torch.ops import denoise as dn

    c = jt.modwt2(x, DB4, level)
    n_bands = 3 * level
    if threshold is None or isinstance(threshold, str):
        kind = threshold or "universal"
        hh1 = c[2].flatten(-2)
        flat = c[:n_bands].flatten(-2)
        if kind == "universal":
            threshold = dn.universal_threshold(hh1)
        elif kind == "sure":
            threshold = dn.sure_threshold(flat, dn.mad_sigma(hh1))
        else:
            threshold = dn.bayes_threshold(flat, dn.mad_sigma(hh1))
        threshold = threshold[..., None, None]
    else:
        threshold = dn._per_image(threshold, x, c.dtype)
    shrink = dn.soft_threshold if mode == "soft" else dn.hard_threshold
    details = shrink(c[:n_bands], threshold)
    return jt.imodwt2(torch.cat([details, c[n_bands:]], dim=0), DB4)


def _inline3(x, level, mode, threshold):
    """The 3D default pipeline as it ran inline before."""
    from jwave_pro_tpu_torch.ops import denoise as dn

    c = jt.modwt3(x, DB4, level)
    n_bands = 7 * level
    if threshold is None or isinstance(threshold, str):
        kind = threshold or "universal"
        hhh1 = c[6].flatten(-3)
        flat = c[:n_bands].flatten(-3)
        if kind == "universal":
            threshold = dn.universal_threshold(hhh1)
        elif kind == "sure":
            threshold = dn.sure_threshold(flat, dn.mad_sigma(hhh1))
        else:
            threshold = dn.bayes_threshold(flat, dn.mad_sigma(hhh1))
        threshold = threshold[..., None, None, None]
    else:
        threshold = dn._per_image(threshold, x, c.dtype, nd=3)
    shrink = dn.soft_threshold if mode == "soft" else dn.hard_threshold
    details = shrink(c[:n_bands], threshold)
    return jt.imodwt3(torch.cat([details, c[n_bands:]], dim=0), DB4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("rule", [None] + RULES)
def test_2d_default_path_is_bitwise_the_inline_formula(rule, mode, dtype):
    x = _images((2, 37, 53), seed=13, dtype=dtype)
    arg = None if rule is None else _threshold_arg(rule, x)[0]
    got = jt.modwt2_denoise(x, DB4, 3, mode=mode, threshold=arg)
    assert torch.equal(got, _inline2(x, 3, mode, arg))


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("rule", [None] + RULES)
def test_3d_default_path_is_bitwise_the_inline_formula(rule, mode):
    x = _images((2, 6, 10, 12), seed=17, dtype=torch.float32)
    arg = None if rule is None else _threshold_arg(rule, x)[0]
    got = jt.modwt3_denoise(x, DB4, 2, mode=mode, threshold=arg)
    assert torch.equal(got, _inline3(x, 2, mode, arg))


def test_an_unknown_rule_is_refused():
    x = _images((2, 16, 16), seed=1)
    for fn in (jt.modwt2_denoise, jt.modwt3_denoise):
        with pytest.raises(ValueError, match="unknown threshold rule"):
            fn(x if fn is jt.modwt2_denoise else x[None], DB4, 1,
               threshold="minimax")


@pytest.mark.cuda
@pytest.mark.parametrize("rule", [None, "sure", "per_image"])
def test_card_default_path_is_bitwise_the_inline_formula(rule):
    """On the card the default path runs the 2D kernels #9 and #10 and the
    median #15; its answers are still bitwise the inline formula's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    x = _images((4, 512, 512), seed=19, dtype=torch.float32).cuda()
    arg = None if rule is None else _threshold_arg(rule, x)[0]
    for mode in ("soft", "hard"):
        got = jt.modwt2_denoise(x, DB4, 3, mode=mode, threshold=arg)
        assert torch.equal(got, _inline2(x, 3, mode, arg))
