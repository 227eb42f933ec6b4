"""Percentiles, rates, the roofline formulas and the trace's arithmetic,
on numbers worked by hand."""
from __future__ import annotations

import numpy as np
import pytest

from wavebench import core, roofline, tracing


@pytest.mark.parametrize("values", [[5.0], [3.0, 1.0], list(range(100)),
                                    [0.2, 9.1, 3.3, 3.3, 7.0, 1.5, 2.25]])
@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_percentile_is_numpy_linear(values, q):
    assert core.percentile(values, q) == pytest.approx(
        float(np.percentile(values, q)), rel=1e-12)


def test_percentile_of_twenty_calls():
    # 95th of 1..20: rank 0.95·19 = 18.05 → 19 + 0.05·(20 − 19)
    assert core.percentile(range(1, 21), 95) == pytest.approx(19.05)


def test_end_to_end_rates():
    win = core.Window(calls=4, samples=4 * 3 * 1000, seconds=0.5,
                      latency_ms=[1.0, 2.0, 3.0, 4.0])
    got = core.end_to_end(win, setup_s=7.5, peak_bytes=3 << 30)
    assert got == {"samples_per_s": 24000.0, "peak_mem_gib": 3.0,
                   "setup_s": 7.5, "p95_ms": pytest.approx(3.85)}
    assert "p95_ms" not in core.end_to_end(
        core.Window(calls=1, samples=10, seconds=1.0), 1.0, 0)


def test_roofline_bounds_of_the_kernel_table():
    # the bounds the port's kernel table gives for #1 and #14
    t, by = roofline.modwt_fwd(32, 1 << 20, 5, 8)
    assert (round(t * 1e3, 4), by) == (0.2805, "bytes")
    t, by = roofline.cwt_ifft(64, 16384, 64)
    assert (round(t * 1e3, 4), by) == (0.1653, "bytes")


def test_roofline_of_the_whole_cwt():
    t, by = roofline.cwt(64, 16384, 64)
    nbytes = 4 * 64 * 16384 + 8 * 64 * 64 * 16384
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # with more operations than bytes the operations set the bound
    t, by = roofline.bound(1.0, 67e12)
    assert (t, by) == (1.0, "operations")


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def synthetic() -> list:
    """A 100 µs window: kernels at 10–30 and 20–40 overlap, a copy at
    60–70, a kernel leaving the window at 95–120; idle 0–10, 40–60 and
    70–95."""
    return [
        ev(tracing.WINDOW, "user_annotation", 1000, 100),
        ev(tracing.CALL, "user_annotation", 1000, 35),
        ev("aten::sort", "cpu_op", 1002, 20),
        ev(tracing.SYNC, "user_annotation", 1035, 50),
        ev("cudaDeviceSynchronize", "cuda_runtime", 1036, 48),
        ev("void jw_modwt_fwd_kernel<float, 8>", "kernel", 1010, 20),
        ev("radixSort", "kernel", 1020, 20),
        ev("Memcpy HtoD", "gpu_memcpy", 1060, 10),
        ev("elementwise", "kernel", 1095, 25),
        ev("outside", "kernel", 900, 50),
        ev("aten::other_thread", "cpu_op", 1000, 100, tid=2),
        ev(tracing.CALL, "gpu_user_annotation", 1010, 30),
    ]


def test_trace_merges_overlaps_and_counts_edge_gaps():
    t = tracing.parse(synthetic())
    assert (t.lo, t.hi, t.calls) == (1000.0, 1100.0, 1)
    assert t.busy() == [(1010.0, 1040.0), (1060.0, 1070.0),
                        (1095.0, 1100.0)]
    assert t.busy_s == pytest.approx(45e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.gaps() == [(1000.0, 1010.0), (1040.0, 1060.0),
                        (1070.0, 1095.0)]
    assert len(t.kernels()) == 3


def test_gaps_are_named_by_the_host():
    labels = tracing.parse(synthetic()).gap_labels()
    assert [name for name, _ in labels] == [
        "wavebench.call",
        "wavebench.sync/cudaDeviceSynchronize",
        "wavebench.sync/cudaDeviceSynchronize"]
    assert [s for _, s in labels] == pytest.approx([10e-6, 20e-6, 25e-6])


def test_breakdown_sums_by_name_and_label():
    got = tracing.breakdown(tracing.parse(synthetic()))
    ops = dict(got["device_ops"])
    assert ops["radixSort"] == pytest.approx(20e-6)
    assert ops["elementwise"] == pytest.approx(5e-6)     # clipped
    gaps = dict(got["idle_gaps"])
    assert gaps["wavebench.sync/cudaDeviceSynchronize"] == pytest.approx(
        45e-6)
    assert len(got["device_ops"]) <= tracing.TOP


def test_idle_metric_reads_the_synthetic_window():
    cell = core.load_cell("modwt_db4_l5.denoise")
    r = core.Reading(cell, core.Window(enqueue_s=[0.001, 0.003, 0.002]),
                     tracing.parse(synthetic()))
    idle = core.metric_reader("device_idle").read(r)
    assert idle == pytest.approx(55.0)
    assert core.metric_reader("kernels_per_call.denoise").read(r) == 3.0
    assert core.metric_reader("enqueue_ms.denoise").read(r) == \
        pytest.approx(2.0)
    # one jw_ kernel of 20 µs among 65 µs of kernels
    assert core.metric_reader("plain_device_share.denoise").read(r) == \
        pytest.approx(100 * 45 / 65)
    # a reader finds nothing to read in a cell it does not serve
    assert core.metric_reader("modwt_fwd_roofline").read(r) is None


def test_stream_rate_reads_the_measured_window():
    cell = core.load_cell("modwt_db4_l5.stream")
    read = core.metric_reader("host_samples_per_s.stream").read
    trace = tracing.parse(synthetic())
    r = core.Reading(cell, core.Window(calls=4, samples=16384, seconds=2.0),
                     trace)
    assert read(r) == pytest.approx(8192.0)
    assert read(core.Reading(cell, core.Window(), trace)) is None


def test_roofline_metric_reads_busy_time():
    cell = core.load_cell("modwt_db4_l5.batch")
    events = [ev(tracing.WINDOW, "user_annotation", 0, 1000)]
    events += [ev(tracing.CALL, "user_annotation", 10 + 350 * i, 5)
               for i in range(2)]
    events += [ev("void jw_modwt_fwd_kernel<float, 8>", "kernel",
                  20 + 350 * i, 350) for i in range(2)]
    r = core.Reading(cell, core.Window(), tracing.parse(events))
    want = 100 * roofline.modwt_fwd(32, 1 << 20, 5, 8)[0] / 350e-6
    assert core.metric_reader("modwt_fwd_roofline").read(r) == \
        pytest.approx(want)
