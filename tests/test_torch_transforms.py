"""The port's transform facades (``transforms.py``) and console demo
(``cli.py``) against the JAX package's, on the CPU.

Each engine is built in both packages from the same name; inputs are
numpy arrays from a seeded ``default_rng``, the JAX calls jitted with the
engine closed over.  Tolerance at float64: 1e-12 × max|ref| (the same
transforms in another summation order).  The MODWT engine's flat reverse
finds N by walking the powers of two where the JAX package walks every
integer: the same N, pinned here at several totals.  The CLI's printed
arrays are parsed and held to JAX's within 1e-12 of their largest value
(XLA and torch leave different last-bit noise where the exact value is
0); every other line and the exit code are equal.
"""
import contextlib
import functools
import io
import re

import numpy as np
import pytest
import torch

import jax

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu import cli as jcli
from jwave_pro_tpu_torch import cli as tcli

NAMES = ["Fast Wavelet Transform", "Wavelet Packet Transform",
         "Maximal Overlap Discrete Wavelet Transform",
         "Shifting Wavelet Transform", "Fast Fourier Transform",
         "Discrete Fourier Transform"]


@functools.lru_cache(maxsize=None)
def _engines(name, wavelet="Daubechies 4"):
    return jw.build_transform(name, wavelet), jt.build_transform(name,
                                                                 wavelet)


@functools.lru_cache(maxsize=None)
def _jit(name, wavelet, method, *static):
    ref = _engines(name, wavelet)[0]
    return jax.jit(lambda *a: getattr(ref, method)(*a, *static))


def _call(name, method, *args, wavelet="Daubechies 4", static=()):
    want = np.asarray(_jit(name, wavelet, method, *static)(*args))
    port = _engines(name, wavelet)[1]
    got = getattr(port, method)(*(torch.from_numpy(np.array(a))
                                  for a in args), *static)
    return got, want


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_build_transform_engines_and_not_known():
    for name in NAMES:
        ref, port = _engines(name)
        assert isinstance(port, jt.Transform)
        assert type(port.engine).__name__ == type(ref.engine).__name__
        if hasattr(ref.engine, "wavelet"):
            assert port.engine.wavelet.name == ref.engine.wavelet.name
    assert jt.build_transform("  fast wavelet TRANSFORM ").engine == \
        jt.FastWaveletTransform(jt.wavelet("Haar"))
    with pytest.raises(jt.NotKnown, match="unknown transform"):
        jt.build_transform("bogus")
    with pytest.raises(jt.NotKnown):
        jt.build_transform("Fast Wavelet Transform", "no such wavelet")
    assert issubclass(jt.NotKnown, ValueError)


@pytest.mark.parametrize("name", NAMES)
def test_engine_1d_round_trip_matches_jax(name):
    x = np.random.default_rng(1).standard_normal(256)
    got, want = _call(name, "forward", x)
    assert _rel(got, want) <= 1e-12
    back, want_back = _call(name, "reverse", want)
    assert _rel(back, want_back) <= 1e-12
    assert _rel(back, x) <= 1e-10


@pytest.mark.parametrize("name", NAMES[:2])
def test_engine_2d_and_3d_match_jax(name):
    rng = np.random.default_rng(2)
    m = rng.standard_normal((16, 32))
    s = rng.standard_normal((4, 8, 16))
    for x in (m, s):
        got, want = _call(name, "forward", x)
        assert _rel(got, want) <= 1e-12
        back, want_back = _call(name, "reverse", want)
        assert _rel(back, want_back) <= 1e-12 and _rel(back, x) <= 1e-10
    got, want = _call(name, "forward", m, static=(2, 3))
    assert _rel(got, want) <= 1e-12


def test_one_dimensional_engines_refuse_2d():
    for name in NAMES[3:]:
        eng = jt.build_transform(name).engine
        with pytest.raises(NotImplementedError, match="1D-only"):
            eng.forward(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="ndim > 3"):
        jt.FastWaveletTransform(jt.wavelet("Haar")).forward(
            torch.zeros(2, 2, 2, 2, dtype=torch.float64))


@pytest.mark.parametrize("name", NAMES[:2])
def test_decompose_recompose_match_jax(name):
    x = np.random.default_rng(3).standard_normal(64)
    got, want = _call(name, "decompose", x)
    assert _rel(got, want) <= 1e-12
    for level in (0, 2, 5):
        back, want_back = _call(name, "recompose", want, static=(level,))
        assert _rel(back, want_back) <= 1e-12


def test_wpt_best_basis_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 256))
    ref = jw.WaveletPacketTransform(jw.wavelet("Symlet 8"))
    port = jt.WaveletPacketTransform(jt.wavelet("Symlet 8"))
    for cost in ("shannon", "logenergy"):
        want = jax.jit(lambda v: ref.best_basis(v, 5, cost))(x)
        got = port.best_basis(torch.from_numpy(x), 5, cost)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            if np.asarray(w).dtype == bool:          # the basis masks
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                assert _rel(g, w) <= 1e-12


@pytest.mark.parametrize("method", ["auto", "direct", "fft"])
def test_modwt_engine_matches_jax(method):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 100))
    ref = jw.MODWTTransform(jw.wavelet("Daubechies 4"), method=method)
    port = jt.MODWTTransform(jt.wavelet("Daubechies 4"), method=method)
    c = port.forward(torch.from_numpy(x), 3)
    want = jax.jit(lambda v: ref.forward(v, 3))(x)
    assert _rel(c, want) <= 1e-12
    assert _rel(port.reverse(c), x) <= 1e-10
    mra = port.mra(torch.from_numpy(x), 3)
    assert _rel(mra, jax.jit(lambda v: ref.mra(v, 3))(x)) <= 1e-12
    x64 = rng.standard_normal(64)
    auto = port.forward_1d(torch.from_numpy(x64))      # level log2(64) = 6
    assert tuple(auto.shape) == (7, 64)
    assert _rel(auto, jax.jit(lambda v: ref.forward_1d(v))(x64)) <= 1e-12
    with pytest.raises(ValueError, match="maximum supported"):
        port.forward_1d(torch.zeros(1 << 14, dtype=torch.float64))


@pytest.mark.parametrize("n,level", [(64, 6), (2, 1), (8, 2), (16, 1),
                                     (1024, 3), (32, 1)])
def test_modwt_flat_interface_finds_jax_n(n, level):
    """The auto N of the flat reverse is the JAX package's: for these
    totals (N·(level+1), e.g. 24 = 8·3, where N = 1, 2 and 4 fail the
    level ≤ log₂N rule) both reconstruct a signal of the same length."""
    ref = jw.MODWTTransform(jw.wavelet("Haar"))
    port = jt.MODWTTransform(jt.wavelet("Haar"))
    flat = np.random.default_rng(n).standard_normal(n * (level + 1))
    try:
        want = np.asarray(jax.jit(ref.reverse_flat)(flat))
    except ValueError:
        with pytest.raises(ValueError):
            port.reverse_flat(torch.from_numpy(flat))
        return
    got = port.reverse_flat(torch.from_numpy(flat))
    assert _rel(got, want) <= 1e-12
    x = np.random.default_rng(0).standard_normal(n)
    f = port.forward_flat(torch.from_numpy(x), level)
    assert tuple(f.shape) == (n * (level + 1),)
    assert _rel(port.reverse_flat(f, n), x) <= 1e-10
    # the auto N need not be the forward's N (16·2 reads as 8·4), as in
    # the reference; where it is, the 1D reverse is the round trip
    if got.shape[-1] == n:
        assert _rel(port.reverse(f), x) <= 1e-10


def test_cwt_engine_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 300))
    scales = [1.0, 2.0, 4.0, 8.0]
    ref = jw.ContinuousWaveletTransform(jw.MorletWavelet())
    port = jt.ContinuousWaveletTransform(jt.MorletWavelet())
    for method in ("transform", "transform_fft", "transform_parallel",
                   "transform_fft_parallel"):
        want = jax.jit(lambda v: getattr(ref, method)(
            v, scales).coefficients)(x)
        got = getattr(port, method)(torch.from_numpy(x), scales)
        assert _rel(got.coefficients, want) <= 1e-12
    got = port.inverse(port.transform_fft(torch.from_numpy(x), scales))
    want = ref.inverse(ref.transform_fft(x, scales))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name", ["Fast Fourier Transform",
                                  "Discrete Fourier Transform"])
def test_fourier_engines_complex_calls_match_jax(name):
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 24)) + 1j * rng.standard_normal((2, 24))
    for method in ("forward_complex", "reverse_complex"):
        eng_ref, eng_port = (t.engine for t in _engines(name))
        want = np.asarray(getattr(eng_ref, method)(z))
        got = getattr(eng_port, method)(torch.from_numpy(z))
        assert got.dtype == torch.complex128 and _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name", ["Fast Wavelet Transform",
                                  "Fast Fourier Transform"])
@pytest.mark.parametrize("real", [False, True])
def test_complex_adapters_match_jax(name, real):
    """The interleaved-real trick on complex input, and on real input
    (imaginary part zero, as ``jnp.imag`` of a real array)."""
    rng = np.random.default_rng(8)
    z = rng.standard_normal(32)
    if not real:
        z = z + 1j * rng.standard_normal(32)
    ref, port = _engines(name)
    for method in ("forward_complex", "reverse_complex"):
        want = np.asarray(getattr(ref, method)(z))
        got = getattr(port, method)(torch.from_numpy(z))
        assert got.dtype == torch.complex128 and _rel(got, want) <= 1e-12
    back = port.reverse_complex(port.forward_complex(torch.from_numpy(z)))
    assert _rel(back, z + 0j) <= 1e-10


def test_aed_and_swt_engines_match_jax():
    x = np.random.default_rng(9).standard_normal((2, 42))
    for wav in ("Haar", "Daubechies 4"):
        ref = jw.Transform(jw.AncientEgyptianDecomposition(
            jw.FastWaveletTransform(jw.wavelet(wav))))
        port = jt.Transform(jt.AncientEgyptianDecomposition(
            jt.FastWaveletTransform(jt.wavelet(wav))))
        for xi in (x[0], x[0, :37]):
            y = port.forward(torch.from_numpy(xi))
            assert _rel(y, ref.forward(xi)) <= 1e-12
            assert _rel(port.reverse(y), xi) <= 1e-10
        y1 = port.forward(torch.from_numpy(x[0]), 1)
        assert _rel(y1, ref.forward(x[0], 1)) <= 1e-12
    swt_ref = jw.ShiftingWaveletTransform(jw.wavelet("Haar"))
    swt = jt.ShiftingWaveletTransform(jt.wavelet("Haar"))
    for n in (32, 33, 42):
        xi = x[1, :n] if n <= 42 else x[1]
        y = swt.forward(torch.from_numpy(xi))
        assert _rel(y, swt_ref.forward(xi)) <= 1e-12
        assert _rel(swt.reverse(y), swt_ref.reverse(np.asarray(
            swt_ref.forward(xi)))) <= 1e-12


def _cli(main, args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(args, **kw)
    return code, out.getvalue()


_NUM = re.compile(r"[-+]?\d+\.\d*(?:e[-+]\d+)?")


def _split(text):
    """The printed arrays as numbers, and every other line as it is."""
    arrays, lines, cur = [], [], None
    for line in text.splitlines():
        if line.split(":")[0] in ("time domain", "hilbert domain",
                                  "reconstructed"):
            cur = []
            arrays.append(cur)
            line = line.split(":", 1)[1]
        elif cur is None or not line.startswith(" "):
            cur = None
            lines.append(line)
            continue
        cur.extend(float(v) for v in _NUM.findall(line))
    return [np.array(a) for a in arrays], lines


@pytest.mark.parametrize("args", [[n, w] for n in NAMES
                                  for w in ("Haar", "Daubechies 4")] + [
    ["Shifting Wavelet Transform", "Legendre 2"],
    ["Maximal Overlap Discrete Wavelet Transform", "BiOrthogonal 3/5"],
    ["bogus transform"], ["Fast Wavelet Transform", "nope"], []])
def test_cli_prints_what_jax_prints(args):
    want_code, want = _cli(jcli.main, args)
    got_code, got = _cli(tcli.main, args, device="cpu")
    assert got_code == want_code
    got_arrays, got_lines = _split(got)
    want_arrays, want_lines = _split(want)
    assert got_lines[:-1] == want_lines[:-1]
    assert len(got_arrays) == len(want_arrays)
    for g, w in zip(got_arrays, want_arrays):
        assert g.shape == w.shape and np.abs(g - w).max() <= \
            1e-12 * np.abs(w).max()
    if want_code != 1:
        err = float(got_lines[-1].split("=")[1])
        assert (err < 1e-6) == (want_code == 0)


def test_cli_codes_cover_zero_one_two():
    assert _cli(tcli.main, ["Fast Wavelet Transform", "Haar"],
                device="cpu")[0] == 0
    assert _cli(tcli.main, ["bogus"], device="cpu")[0] == 1
    assert _cli(tcli.main, ["Shifting Wavelet Transform", "Legendre 2"],
                device="cpu")[0] == 2
