"""The program's spans (``utils/profiling.py:span``, ``spanned``) and its
one launch count (``kernels/modwt_cuda.py:LAUNCHES``).

With no profiler running a span is the one shared null context and
``record_function`` is never called.  Under ``torch.profiler`` the spans
of ``modwt_denoise``, ``cwt`` and a ``StreamingMODWT.update`` nest as
the stages run: the threshold and the shrink inside the denoise, the
host-to-device copies of the axes inside the CWT, the buffer's stages
inside the update, and a launch inside the transform that makes it.  On
the card (``cuda``), a launch's span holds its ``cudaLaunchKernel`` and
``LAUNCHES`` counts eager and served launches alike.
"""
import importlib
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch import streaming as st
from jwave_pro_tpu_torch.kernels.modwt_cuda import LAUNCHES, op_taps

profiling = importlib.import_module("jwave_pro_tpu_torch.utils.profiling")

DB4 = jt.wavelet("Daubechies 4")
ACTS = [torch.profiler.ProfilerActivity.CPU]


def _signal(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _stream(seed=0):
    """A CPU stream past its halo, and its next chunk (host NumPy)."""
    s = st.StreamingMODWT(DB4, st.StreamingConfig(1024, 3, device="cpu"))
    rng = np.random.default_rng(seed)
    for _ in range(3):
        s.update(rng.standard_normal(128).astype(np.float32))
    return s, rng.standard_normal(128).astype(np.float32)


def _calls():
    """The three calls the spans are checked on, as thunks."""
    x = _signal(2, 1000, seed=1)
    scales = jt.generate_log_scales(1.0, 32.0, 6)
    stream, chunk = _stream()
    return {"modwt_denoise": lambda: jt.modwt_denoise(x, DB4, 3),
            "cwt": lambda: jt.cwt(x, scales),
            "update": lambda: stream.update(chunk)}


def _profiled(fn, activities=ACTS):
    """The ``user_annotation`` and runtime events of ``fn`` run under a
    profiler, as (name, category, start, end), by start."""
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["cat"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "user_annotation", "cuda_runtime", "cuda_driver")),
                  key=lambda e: (e[2], -e[3]))


def _parents(events):
    """Each ``jwave.*`` span's innermost enclosing ``jwave.*`` span (None
    at the top), as a list of (name, parent) in start order."""
    out, stack = [], []
    for name, cat, s, e in events:
        if cat != "user_annotation" or not name.startswith("jwave."):
            continue
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, e))
    return out


# -- with no profiler ---------------------------------------------------------

def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("jwave.a"), profiling.span("jwave.b")
    assert a is b is profiling._NULL
    with a as got:
        assert got is None


@pytest.mark.parametrize("call", ["modwt_denoise", "cwt", "update"])
def test_no_profiler_never_records(monkeypatch, call):
    """Every span site of the call is guarded: with ``record_function``
    made to raise, the call runs and gives the answer it gives with the
    real one."""
    want = _calls()[call]()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got = _calls()[call]()
    got, want = (getattr(v, "coefficients", v) for v in (got, want))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_spanned_keeps_the_function():
    @profiling.spanned("jwave.test")
    def f(a, b=2):
        """doc"""
        return a + b

    assert f(1, b=3) == 4 and f.__name__ == "f" and f.__doc__ == "doc"
    assert jt.modwt.__name__ == "modwt" and "level" in jt.modwt.__doc__


# -- under a CPU profiler -----------------------------------------------------

NESTING = {
    "modwt_denoise": [("jwave.modwt_denoise", None),
                      ("jwave.modwt", "jwave.modwt_denoise"),
                      ("jwave.denoise.threshold", "jwave.modwt_denoise"),
                      ("jwave.denoise.shrink", "jwave.modwt_denoise"),
                      ("jwave.imodwt", "jwave.modwt_denoise")],
    "cwt": [("jwave.cwt", None), ("jwave.cwt.axes", "jwave.cwt"),
            ("jwave.cwt.axes", "jwave.cwt")],
    "update": [("jwave.stream.update", None),
               ("jwave.stream.chunk", "jwave.stream.update"),
               ("jwave.stream.append", "jwave.stream.update"),
               ("jwave.stream.window", "jwave.stream.update"),
               ("jwave.stream.tail", "jwave.stream.update"),
               ("jwave.modwt", "jwave.stream.tail"),
               ("jwave.stream.splice", "jwave.stream.update")],
}


@pytest.mark.parametrize("call", sorted(NESTING))
def test_spans_nest_as_the_stages_run(call):
    fn = _calls()[call]
    fn()                                  # multipliers built and cached
    got = [p for p in _parents(_profiled(fn))
           if p[0] != "jwave.cwt.multipliers"]
    assert got == NESTING[call]


def test_the_fused_denoise_spans_its_threshold():
    x = _signal(2, 1000, seed=2)
    got = _parents(_profiled(lambda: jt.modwt_denoise(x, DB4, 3,
                                                      method="fused")))
    assert got[:3] == [("jwave.modwt_denoise", None),
                       ("jwave.modwt", "jwave.modwt_denoise"),
                       ("jwave.denoise.threshold", "jwave.modwt_denoise")]
    # a given threshold takes no estimate
    names = [n for n, _ in _parents(_profiled(
        lambda: jt.modwt_denoise(x, DB4, 3, threshold=0.5)))]
    assert "jwave.denoise.threshold" not in names
    assert "jwave.denoise.shrink" in names


def test_multipliers_span_only_when_built():
    """The first call at a new grid builds the half-spectrum multipliers
    and their device copy; a second with the same scales builds nothing."""
    x = _signal(3, 777, seed=3)
    scales = jt.generate_log_scales(1.37, 41.3, 7)
    first = [n for n, _ in _parents(_profiled(lambda: jt.cwt(x, scales)))]
    again = [n for n, _ in _parents(_profiled(lambda: jt.cwt(x, scales)))]
    assert first.count("jwave.cwt.multipliers") == 3   # host A, B on device
    assert "jwave.cwt.multipliers" not in again
    assert again.count("jwave.cwt.axes") == 2


def test_a_refused_launch_is_spanned_and_not_counted():
    """The operator's registered CPU kernel is the counted launch: a CPU
    tensor raises inside its span, and the launch does not count."""
    g, h = op_taps(DB4)
    before = LAUNCHES["modwt_fwd"]

    def call():
        with pytest.raises(ValueError, match="CUDA tensor"):
            torch.ops.jwave.modwt_fwd(_signal(2, 64), g, h, 2)

    names = [n for n, _ in _parents(_profiled(call))]
    assert names == ["jwave.launch.modwt_fwd"]
    assert LAUNCHES["modwt_fwd"] == before


def test_no_span_while_torch_traces():
    """Under a running profiler a span records, but not while torch
    traces an export: its graph then keeps no profiler operator, and it
    serves what the export made without a profiler serves."""
    seen = []

    def fn(v):
        seen.append(profiling.span("jwave.test") is profiling._NULL)
        return jt.modwt(v, DB4, 2, method="direct")

    x = _signal(2, 256, seed=4)
    plain = jt.export_pipeline(fn, x)
    with torch.profiler.profile(activities=ACTS):
        assert profiling.span("jwave.test") is not profiling._NULL
        under = jt.export_pipeline(fn, x)
    assert seen and all(seen)
    targets = [str(n.target) for n in jt.load_pipeline(under).graph.nodes]
    assert not [t for t in targets if "record_function" in t]
    torch.testing.assert_close(jt.load_pipeline(under)(x),
                               jt.load_pipeline(plain)(x), rtol=0, atol=0)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_launch_span_holds_its_kernel_launch(dev):
    x = _signal(4, 8192, seed=5).to(dev)
    jt.modwt(x, DB4, 3)
    torch.cuda.synchronize()
    events = _profiled(lambda: (jt.modwt(x, DB4, 3),
                                torch.cuda.synchronize()),
                       ACTS + [torch.profiler.ProfilerActivity.CUDA])
    spans = [(s, e) for n, _, s, e in events
             if n == "jwave.launch.modwt_fwd"]
    launches = [s for n, c, s, _ in events
                if c == "cuda_runtime" and n.startswith("cudaLaunch")]
    assert len(spans) == 1 and launches
    lo, hi = spans[0]
    assert [s for s in launches if lo <= s < hi]


@pytest.mark.cuda
def test_launches_count_eager_and_served_alike(dev):
    x = _signal(8, 8192, seed=6).to(dev)
    fn = lambda v: jt.modwt_denoise(v, DB4, 5, threshold=0.8)  # noqa: E731
    served = jt.load_pipeline(jt.export_pipeline(fn, x,
                                                 batch_polymorphic=True))
    for call in (lambda: fn(x), lambda: served(x), lambda: served(x[:3])):
        before = LAUNCHES.copy()
        call()
        torch.cuda.synchronize()
        ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
               if LAUNCHES[k] != before[k]}
        assert ran == {"modwt_fwd": 1, "modwt_inv": 1}
