"""The port's profiling helpers (``utils/profiling.py``) against the JAX
package's, on the CPU.

``time_chain`` is held to JAX's contract (``jwave_pro_tpu/utils/
profiling.py:15-53``): the same signature, each output fed to the next
call, one untimed run of each chain, then (t_long − t_short)/(k_long −
k_short) per repeat aggregated as the upper median of the positive
differences, 1e-9 when none.  The aggregation is checked on a scripted
``time.perf_counter`` given to both packages, so the two results are
equal exactly.  ``trace`` writes a ``torch.profiler`` trace on the CPU.
"""
import importlib
import inspect
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jwave_pro_tpu_torch as jt

jprof = importlib.import_module("jwave_pro_tpu.utils.profiling")
tprof = importlib.import_module("jwave_pro_tpu_torch.utils.profiling")

DB4 = jt.wavelet("Daubechies 4")


def test_exports_are_the_jax_modules():
    assert tprof.__all__ == jprof.__all__ == [
        "time_chain", "measure_samples_per_sec", "trace"]
    assert jt.time_chain is tprof.time_chain


@pytest.mark.parametrize("name", ["time_chain", "measure_samples_per_sec",
                                  "trace"])
def test_signature_is_the_jax_one(name):
    """Names, order, kinds and defaults of every parameter; ``trace``'s
    default directory names torch where JAX's names jax, and lies in the
    process's temporary directory where JAX's lies in ``/tmp``."""
    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    want = params(getattr(jprof, name))
    got = params(getattr(tprof, name))
    if name == "trace":
        assert want[0][2] == "/tmp/jax-trace"
        default = os.path.join(tempfile.gettempdir(), "torch-trace")
        want = [(n, k, default) for n, k, _ in want]
    assert got == want


def _recorder():
    seen = []

    def step(v):
        seen.append(v.clone())
        return v + 1

    return step, seen


@pytest.mark.parametrize("k_short,k_long,repeats", [(2, 5, 3), (1, 3, 1),
                                                    (4, 24, 0)])
def test_each_output_feeds_the_next_call(k_short, k_long, repeats):
    """Untimed short and long chains, then ``repeats`` (short, long)
    pairs; every chain starts from ``x`` and each call gets the previous
    call's output.  Positional arguments as JAX takes them."""
    step, seen = _recorder()
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    tprof.time_chain(step, x, k_short, k_long, repeats)
    chains = [k_short, k_long] * (1 + repeats)
    assert len(seen) == (k_short + k_long) * (1 + repeats) == sum(chains)
    i = 0
    for k in chains:
        for j in range(k):
            torch.testing.assert_close(seen[i], x + j, rtol=0, atol=0)
            i += 1


def test_default_chain_lengths_count_calls():
    step, seen = _recorder()
    tprof.time_chain(step, torch.zeros(4))
    assert len(seen) == (4 + 24) * (1 + 5)
    step, seen = _recorder()
    tprof.measure_samples_per_sec(step, torch.zeros(4))
    assert len(seen) == (4 + 24) * (1 + 3)


class _ScriptedClock:
    """``time.perf_counter`` stand-in: each timed chain lasts the next of
    the given durations (short, long, short, long, ...)."""

    def __init__(self, durations):
        stamps, now = [], 0.0
        for d in durations:
            stamps += [now, now + d]
            now += d
        self.stamps = iter(stamps)
        self.calls = 0

    def perf_counter(self):
        self.calls += 1
        return next(self.stamps)


def _script(pairs):
    """Durations for (t_short, t_long) pairs, with two stamps a chain."""
    return [t for pair in pairs for t in pair]


def _upper_median_rule(pairs, k_short, k_long):
    diffs = [(t_l - t_s) / (k_long - k_short) for t_s, t_l in pairs]
    pos = sorted(d for d in diffs if d > 0)
    return max(pos[len(pos) // 2], 1e-9) if pos else 1e-9


SCRIPTS = {
    # five positive differences (odd count): the middle one
    "odd": [(0.010, 0.090), (0.010, 0.050), (0.020, 0.220), (0.010, 0.170),
            (0.015, 0.115)],
    # four positive differences (even count): the upper of the two middles
    "even": [(0.010, 0.090), (0.010, 0.050), (0.020, 0.220),
             (0.010, 0.170)],
    # a mix of signs: a stall during the short run makes it negative
    "mixed": [(0.300, 0.090), (0.010, 0.050), (0.500, 0.020), (0.010, 0.170),
              (0.010, 0.010)],
    # every difference negative
    "negative": [(0.300, 0.090), (0.400, 0.050), (0.500, 0.020)],
    # one positive difference below the floor
    "tiny": [(0.0100000, 0.0100000001), (0.2, 0.1)],
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_aggregation_matches_jax_on_a_scripted_clock(monkeypatch, case):
    pairs = SCRIPTS[case]
    k_short, k_long = 4, 24
    want = _upper_median_rule(pairs, k_short, k_long)
    if case == "negative":
        assert want == 1e-9
    results = []
    for mod, x, step in (
            (jprof, jnp.zeros(8), lambda v: v * 0.5),
            (tprof, torch.zeros(8), lambda v: v * 0.5)):
        clock = _ScriptedClock(_script(pairs))
        monkeypatch.setattr(mod, "time", clock)
        results.append(mod.time_chain(step, x, k_short, k_long, len(pairs)))
        assert clock.calls == 4 * len(pairs)
    assert results[0] == results[1] == pytest.approx(want, rel=1e-12)


def test_measure_samples_per_sec_is_numel_over_time_chain(monkeypatch):
    pairs = SCRIPTS["odd"][:3]
    x = np.zeros((4, 16), np.float32)
    per_step = _upper_median_rule(pairs, 2, 7)
    got = []
    for mod, arg in ((jprof, jnp.asarray(x)), (tprof, torch.from_numpy(x))):
        monkeypatch.setattr(mod, "time", _ScriptedClock(_script(pairs)))
        got.append(mod.measure_samples_per_sec(lambda v: v + 1, arg, 2, 7,
                                               len(pairs)))
    assert got[0] == got[1] == pytest.approx(64 / per_step, rel=1e-12)


def test_cpu_tensor_is_timed_on_the_host_clock():
    """A CPU tensor stays on the CPU, and the time is positive."""
    devices = set()

    def step(v):
        devices.add(v.device.type)
        return jt.modwt(v, DB4, 2)[2]

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 512)))
    dt = tprof.time_chain(step, x, 1, 3, 2)
    assert devices == {"cpu"}
    assert 0 < dt < 10


def _trace_files(path):
    return sorted(path.glob("*.pt.trace.json"))


def test_trace_writes_a_profiler_trace(tmp_path):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 256)))
    with tprof.trace(tmp_path) as logdir:
        assert torch._C._autograd._profiler_enabled()
        jt.modwt(x, DB4, 3)
    assert logdir == tmp_path
    assert not torch._C._autograd._profiler_enabled()
    (path,) = _trace_files(tmp_path)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_trace_stops_the_profiler_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError, match="inside the trace"):
        with tprof.trace(tmp_path / "raised"):
            torch.ones(3).sum()
            raise ValueError("inside the trace")
    assert not torch._C._autograd._profiler_enabled()
    assert len(_trace_files(tmp_path / "raised")) == 1
    # a second trace starts: the first one is not left running
    with tprof.trace(tmp_path / "again"):
        torch.ones(3).sum()
    assert len(_trace_files(tmp_path / "again")) == 1
