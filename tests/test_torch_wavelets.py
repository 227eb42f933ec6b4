"""The port's wavelet registry against the JAX package's.

A wavelet's parameters are its four filter banks, so the banks must be
equal EXACTLY (both packages build them from equal ``_taps.py`` tables, the
port from its own copy, with the same float64 arithmetic): any difference
would make every transform comparison downstream meaningless.
"""
import shutil
import subprocess
import sys
from pathlib import Path

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


def test_port_taps_equal_jax_taps_exactly():
    from jwave_pro_tpu.wavelets import _taps as jax_taps
    from jwave_pro_tpu_torch.wavelets import _taps as port_taps

    assert port_taps.TAPS == jax_taps.TAPS


def test_port_runs_without_the_jax_package(tmp_path):
    """The port copied alone runs the MODWT, the decimated pyramid, the
    packet denoise, the pywt-style lists, the lifting pyramid, the DTCWT,
    the banded CWT, the Hilbert transform, the wavelet coherence, the 2D
    CWT, synchrosqueezing and its ridges, both scattering transforms, the
    EWT, a stream, the preprocessing chain, a facade, the value stores, the
    test signals, an exported pipeline and a sharded MODWT round trip on a
    one-rank gloo mesh that ``make_mesh`` starts, and never loads JAX or
    the JAX package."""
    port = Path(jt.__file__).resolve().parent
    shutil.copytree(port, tmp_path / port.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = (
        "import sys, torch\n"
        "import jwave_pro_tpu_torch as jt\n"
        "c = jt.modwt(torch.randn(2, 100, dtype=torch.float64), "
        "jt.wavelet('db4'), 3)\n"
        "assert tuple(c.shape) == (4, 2, 100), c.shape\n"
        "x = torch.randn(2, 512, dtype=torch.float64)\n"
        "w = jt.wavelet('db4')\n"
        "y = jt.fwt(x, w, 5)\n"
        "assert torch.allclose(jt.ifwt(y, w, 5), x), 'fwt round trip'\n"
        "d = jt.wpt_denoise(x, jt.wavelet('Symlet 8'), 4, mode='hard')\n"
        "assert d.shape == x.shape and bool(torch.isfinite(d).all())\n"
        "cs = jt.wavedec(x, w, 3)\n"
        "assert [tuple(v.shape) for v in cs] == "
        "[(2, 64), (2, 64), (2, 128), (2, 256)]\n"
        "z = jt.icdf97(jt.cdf97(x, 4), 4)\n"
        "assert torch.allclose(z, x), 'cdf97 round trip'\n"
        "r = jt.dtcwt(x, 4)\n"
        "assert torch.allclose(jt.idtcwt(r), x), 'dtcwt round trip'\n"
        "s = jt.generate_log_scales(1.0, 32.0, 8)\n"
        "cb = jt.cwt(x, s, method='banded').coefficients\n"
        "cf = jt.cwt(x, s, method='fft').coefficients\n"
        "assert torch.allclose(cb, cf, atol=1e-9), 'banded vs fft'\n"
        "assert jt.wavelet_coherence(x, x, s).coherence.shape == (2, 8, 512)\n"
        "assert jt.hilbert(x).dtype == torch.complex128\n"
        "img = torch.randn(2, 32, 32, dtype=torch.float64)\n"
        "assert jt.icwt2(jt.cwt2(img, [1.0, 2.0])).shape == img.shape\n"
        "r = jt.ssq_cwt(x, s)\n"
        "assert jt.extract_ridges(r.Tx).indices.shape == (2, 1, 512)\n"
        "assert jt.issq_cwt(r).shape == x.shape\n"
        "assert jt.scattering1d(x, 3, 2).s2.shape[-1] == 64\n"
        "assert jt.scattering2d(img, 2, 2).s1.shape == (2, 4, 8, 8)\n"
        "e = jt.ewt1d(x, 3)\n"
        "assert torch.allclose(e.reconstruct(), x), 'ewt round trip'\n"
        "st = jt.streaming.StreamingMODWT(w, jt.streaming.StreamingConfig(\n"
        "    256, 3, device='cpu'))\n"
        "assert st.update(torch.ones(64)).shape == (4, 256)\n"
        "from jwave_pro_tpu_torch import cli, datatypes\n"
        "from jwave_pro_tpu_torch.utils import deploy, signals\n"
        "p = torch.from_numpy(signals.sine_oscillation(512) + 3.0)\n"
        "z, sig = jt.preprocess_prices(p[None].repeat(2, 1))\n"
        "assert z.shape == (2, 512) and bool(torch.isfinite(z).all())\n"
        "t = jt.build_transform('Fast Wavelet Transform', 'db4')\n"
        "assert torch.allclose(t.reverse(t.forward(x[0])), x[0])\n"
        "ln = datatypes.Line.create(4, device='cpu').set(1, 2.0)\n"
        "assert float(ln.get(1)) == 2.0 and callable(cli.main)\n"
        "f = deploy.load_pipeline(deploy.export_pipeline(\n"
        "    lambda v: jt.fwt(v, w, 3), x, batch_polymorphic=True))\n"
        "assert torch.equal(f(x[:1]), jt.fwt(x[:1], w, 3))\n"
        "from jwave_pro_tpu_torch import parallel as par\n"
        "m = par.make_mesh({'signal': 1}, device_type='cpu')\n"
        "c = par.modwt_sharded(x, w, 3, m)\n"
        "assert torch.allclose(c.full_tensor(), jt.modwt(x, w, 3))\n"
        "assert torch.allclose(par.imodwt_sharded(c, w, m).full_tensor(), x)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'jwave_pro_tpu']\n"
        "assert not bad, bad\n"
        "print('stand-alone ok')\n")
    done = subprocess.run(
        [sys.executable, "-I", "-c",
         f"import sys; sys.path.insert(0, {str(tmp_path)!r}); "
         f"exec({script!r})"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "stand-alone ok" in done.stdout


def test_no_port_module_imports_jax_or_the_jax_package():
    """No module of the port (nor ``chip_smoke.py``) names ``jax`` or
    ``jwave_pro_tpu`` in an import statement, at any depth (a function's
    local import included)."""
    import ast

    port = Path(jt.__file__).resolve().parent
    files = sorted(port.rglob("*.py")) + [port.parent / "chip_smoke.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in ("jax", "jwave_pro_tpu")]
    assert len(files) > 30
    assert not found, found


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """API parity: every public name of ``jwave_pro_tpu`` that is not a
    module exists in the port, and the modules it exposes — with
    ``datatypes``, ``cli``, ``utils.signals`` and ``utils.deploy`` — have
    counterpart modules."""
    import importlib
    import types

    names = [n for n in dir(jw) if not n.startswith("_")]
    values = [n for n in names
              if not isinstance(getattr(jw, n), types.ModuleType)]
    assert len(values) >= 193
    assert [n for n in values if not hasattr(jt, n)] == []
    modules = [n for n in names
               if isinstance(getattr(jw, n), types.ModuleType)]
    for mod in modules + ["datatypes", "cli", "utils.signals",
                          "utils.deploy", "ops.financial", "parallel",
                          "parallel.mesh", "parallel.sharded"]:
        importlib.import_module(f"jwave_pro_tpu.{mod}")
        port = importlib.import_module(f"jwave_pro_tpu_torch.{mod}")
        assert port.__name__ == f"jwave_pro_tpu_torch.{mod}"
    # the sharded tier, name for name, with ``init_distributed`` of
    # ``parallel.mesh`` exported from the package as well
    jpar = importlib.import_module("jwave_pro_tpu.parallel")
    tpar = importlib.import_module("jwave_pro_tpu_torch.parallel")
    want = set(jpar.__all__) | {"init_distributed"}
    assert set(tpar.__all__) == want
    assert all(hasattr(tpar, n) for n in want)
    for mod in ("mesh", "sharded"):
        jmod = importlib.import_module(f"jwave_pro_tpu.parallel.{mod}")
        tmod = importlib.import_module(f"jwave_pro_tpu_torch.parallel.{mod}")
        assert [n for n in jmod.__all__ if not hasattr(tmod, n)] == []
    for name in ("Line", "Block", "Space", "SuperLine"):
        assert hasattr(importlib.import_module("jwave_pro_tpu_torch."
                                               "datatypes"), name)


def _jax_modules():
    """Every module of ``jwave_pro_tpu`` but ``kernels/``, dotted below the
    package ('' for the package itself), from the source tree."""
    root = Path(jw.__file__).resolve().parent
    mods = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        if parts[0] == "kernels":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("mod", _jax_modules())
def test_every_module_has_its_public_names_in_the_port(mod):
    """Module by module: each public name of a JAX module (its
    ``__all__``, or else the public functions and classes it defines)
    exists on the port's module of the same dotted name."""
    import importlib
    import inspect

    jmod = importlib.import_module(f"jwave_pro_tpu{'.' * bool(mod)}{mod}")
    tmod = importlib.import_module(
        f"jwave_pro_tpu_torch{'.' * bool(mod)}{mod}")
    if hasattr(jmod, "__all__"):
        names = list(jmod.__all__)
    else:
        names = [n for n, v in vars(jmod).items()
                 if not n.startswith("_")
                 and (inspect.isfunction(v) or inspect.isclass(v))
                 and v.__module__ == jmod.__name__]
    assert [n for n in names if not hasattr(tmod, n)] == []
