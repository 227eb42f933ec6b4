"""The program's spans read from a traced window (``spans.py``) and the
per-layer metrics that read them, on windows worked by hand; a window of
a program without spans leaves every one of them with nothing to read."""
from __future__ import annotations

import pytest

from wavebench import core, spans, tracing

from .helpers import small


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def launch(ts, name="cudaLaunchKernel"):
    return ev(name, "cuda_runtime", ts, 5)


def denoise_window(threshold_in_second=False, drop=None, skew=0) -> list:
    """Two closed-loop denoise calls.  The first estimates its threshold:
    a sort kernel, a fill and a median kernel, 30 + 2 + 20 µs, among
    132 µs of device time; the second takes a given threshold, 80 µs.
    Launch spans of 40, 30, 30 and 30 µs.  ``skew`` moves the device's
    clock against the host's."""
    events = [
        span(tracing.WINDOW, 0, 1000),
        span(tracing.CALL, 0, 300),
        span("jwave.modwt_denoise", 5, 285),
        span("jwave.launch.modwt_fwd", 10, 40), launch(20),
        span("jwave.denoise.threshold", 60, 90), launch(70),
        launch(80, "cudaMemsetAsync"), launch(100),
        span("jwave.denoise.shrink", 160, 40), launch(170),
        span("jwave.launch.modwt_inv", 210, 30), launch(220),
        span(tracing.SYNC, 300, 100),
        ev("cudaDeviceSynchronize", "cuda_runtime", 301, 98),
        ev("jw_modwt_fwd_kernel", "kernel", 35, 40),
        ev("radixSort", "kernel", 80, 30),
        ev("Memset (Device)", "gpu_memset", 112, 2),
        ev("median", "kernel", 115, 20),
        ev("shrink", "kernel", 180, 10),
        ev("jw_modwt_inv_kernel", "kernel", 235, 30),
        span(tracing.CALL, 400, 300),
        span("jwave.modwt_denoise", 405, 290),
        span("jwave.launch.modwt_fwd", 410, 30), launch(420),
        span("jwave.denoise.shrink", 450, 20), launch(455),
        span("jwave.launch.modwt_inv", 500, 30), launch(510),
        ev("jw_modwt_fwd_kernel", "kernel", 440, 40),
        ev("shrink", "kernel", 485, 10),
        ev("jw_modwt_inv_kernel", "kernel", 530, 30),
        span(tracing.SYNC, 700, 100),
    ]
    if threshold_in_second:
        events.append(span("jwave.denoise.threshold", 445, 4))
    if drop is not None:
        events = [e for e in events if e["name"] != drop]
    return [dict(e, ts=e["ts"] + skew) if e["cat"] in tracing.DEVICE_CATS
            else e for e in events]


def stream_window() -> list:
    """Two updates of 380 and 200 µs: the buffer's stages take 170 and
    110 µs of them; the tail's launch 40 and 30."""
    return [
        span(tracing.WINDOW, 0, 1000),
        span(tracing.CALL, 0, 400),
        span("jwave.stream.update", 10, 380),
        span("jwave.stream.chunk", 15, 30),
        span("jwave.stream.append", 50, 50),
        span("jwave.stream.window", 100, 50),
        span("jwave.stream.tail", 150, 150),
        span("jwave.modwt", 155, 140),
        span("jwave.launch.modwt_fwd", 160, 40), launch(170),
        span("jwave.stream.splice", 300, 40),
        span(tracing.CALL, 500, 300),
        span("jwave.stream.update", 500, 200),
        span("jwave.stream.chunk", 505, 10),
        span("jwave.stream.append", 520, 40),
        span("jwave.stream.window", 560, 20),
        span("jwave.stream.tail", 580, 70),
        span("jwave.launch.modwt_fwd", 600, 30), launch(610),
        span("jwave.stream.splice", 650, 40),
        ev("jw_modwt_fwd_kernel", "kernel", 220, 5),
        ev("jw_modwt_fwd_kernel", "kernel", 640, 5),
    ]


def cwt_window() -> list:
    """Three back-to-back CWT calls, each with two axis copies: 7, 13 and
    3 µs a call."""
    events = [span(tracing.WINDOW, 0, 400)]
    for i, (a, b) in enumerate(((5, 2), (10, 3), (2, 1))):
        t = 100 * i
        events += [span(tracing.CALL, t, 100), span("jwave.cwt", t, 99),
                   span("jwave.cwt.axes", t + 10, a),
                   span("jwave.cwt.axes", t + 90, b),
                   ev("c2r", "kernel", t + 30, 40)]
    return events


def reading(name: str, events: list) -> core.Reading:
    return core.Reading(core.load_cell(name), core.Window(),
                        tracing.parse(events))


def read(metric: str, cell: str, events: list):
    return core.metric_reader(metric).read(reading(cell, events))


DENOISE, STREAM, CWT = ("modwt_db4_l5.denoise", "modwt_db4_l5.stream",
                        "cwt_morlet6_s64.batch")


def test_interval_arithmetic():
    assert spans.covered([(0, 10), (5, 20), (30, 31)]) == 21
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap([], [(0, 1)]) == 0
    windows = [(0.0, 10.0), (20.0, 30.0)]
    assert [spans.inside(p, windows) for p in (-1, 0, 9.9, 10, 25, 30)] == [
        False, True, True, False, True, False]


def test_named_and_prefixed_spans():
    t = tracing.parse(denoise_window())
    assert spans.named(t, "jwave.denoise.threshold") == [(60.0, 150.0)]
    assert [e - s for s, e in spans.prefixed(t, "jwave.launch.")] == [
        40, 30, 30, 30]
    assert spans.per_call(t, spans.named(t, "jwave.denoise.shrink")) == [
        40, 20]


FIRST_CALL = [(20, "jw_modwt_fwd_kernel"), (70, "radixSort"),
              (80, "Memset (Device)"), (100, "median"), (170, "shrink"),
              (220, "jw_modwt_inv_kernel")]


def test_match_pairs_each_enqueue_with_its_operation():
    pairs = spans.matched(tracing.parse(denoise_window()))
    assert len(pairs) == 9
    assert [(at, op[0]) for at, op in pairs[:6]] == FIRST_CALL


@pytest.mark.parametrize("skew", [-30, 60])
def test_match_takes_no_notice_of_the_clocks(skew):
    """A device clock some way off the host's (operations shown before
    their enqueues, or into the next call) matches as one in step."""
    pairs = spans.matched(tracing.parse(denoise_window(skew=skew)))
    assert [(at, op[0]) for at, op in pairs[:6]] == FIRST_CALL
    assert read("threshold_device_share.denoise", DENOISE,
                denoise_window(skew=skew)) == pytest.approx(100 * 52 / 212)


def test_operations_the_skew_moves_out_of_the_window():
    """Moved 80 µs early, the first kernel leaves the window: the rest
    match with the first enqueue dropped, and its 40 µs are not counted."""
    trace = tracing.parse(denoise_window(skew=-80))
    assert len(trace.device) == 8
    pairs = spans.matched(trace)
    assert [(at, op[0]) for at, op in pairs[:5]] == FIRST_CALL[1:]
    assert read("threshold_device_share.denoise", DENOISE,
                denoise_window(skew=-80)) == pytest.approx(100 * 52 / 172)


def test_an_enqueue_inside_another_is_the_same_enqueue():
    nested = denoise_window() + [ev("cuLaunchKernel", "cuda_driver", 71, 2)]
    assert len(spans.matched(tracing.parse(nested))) == 9
    assert read("threshold_device_share.denoise", DENOISE,
                nested) == pytest.approx(100 * 52 / 212)


@pytest.mark.parametrize("drop", ["Memset (Device)", "cudaMemsetAsync"])
def test_a_positional_mismatch_matches_nothing(drop):
    t = tracing.parse(denoise_window(drop=drop))
    assert spans.matched(t) is None
    assert read("threshold_device_share.denoise", DENOISE,
                denoise_window(drop=drop)) is None


def test_threshold_share_of_the_calls_device_time():
    # the second call takes a given threshold: its 80 µs count below only
    got = read("threshold_device_share.denoise", DENOISE, denoise_window())
    assert got == pytest.approx(100 * 52 / 212)
    # a threshold span that enqueues nothing adds nothing
    got = read("threshold_device_share.denoise", DENOISE,
               denoise_window(threshold_in_second=True))
    assert got == pytest.approx(100 * 52 / 212)


def test_launch_host_time_is_the_median_launch_span():
    assert read("launch_host_us.denoise", DENOISE,
                denoise_window()) == pytest.approx(30.0)
    assert read("launch_host_us.stream", STREAM,
                stream_window()) == pytest.approx(35.0)


def test_buffer_share_of_the_updates_host_time():
    got = read("buffer_host_share.stream", STREAM, stream_window())
    assert got == pytest.approx(100 * (170 + 110) / (380 + 200))


def test_axes_time_is_the_median_call():
    got = read("axes_host_ms.cwt", CWT, cwt_window())
    assert got == pytest.approx(7e-3)


def without_program_spans(events):
    return [e for e in events if not e["name"].startswith("jwave.")]


@pytest.mark.parametrize("metric,cell,window", [
    ("launch_host_us.denoise", DENOISE, denoise_window),
    ("launch_host_us.stream", STREAM, stream_window),
    ("threshold_device_share.denoise", DENOISE, denoise_window),
    ("buffer_host_share.stream", STREAM, stream_window),
    ("axes_host_ms.cwt", CWT, cwt_window)])
def test_a_program_without_spans_reads_nothing(metric, cell, window):
    assert read(metric, cell, window()) is not None
    assert read(metric, cell, without_program_spans(window())) is None


@pytest.mark.parametrize("name,metric", [
    ("cwt_morlet6_s64.batch", "axes_host_ms.cwt"),
    ("modwt_db4_l5.stream", "buffer_host_share.stream")])
def test_cut_cells_report_their_host_spans_on_the_cpu(name, metric):
    """The program's spans on the host need no card: a traced cut cell
    reads them; launches and device operations there are the card's."""
    got = core.run(small(name), 2_147_483_659, 0.1, trace=True,
                   device="cpu")
    assert got["correct"]
    assert got["metrics"][metric]["value"] > 0
    assert not [m for m in got["metrics"] if m.startswith(
        ("launch_host_us", "threshold_device_share"))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,metrics", [
    ("modwt_db4_l5.denoise", ("launch_host_us.denoise",
                              "threshold_device_share.denoise")),
    ("modwt_db4_l5.stream", ("launch_host_us.stream",
                             "buffer_host_share.stream")),
    ("cwt_morlet6_s64.batch", ("axes_host_ms.cwt",))])
def test_cut_cells_report_their_spans_on_the_card(cuda, name, metrics):
    got = core.run(small(name), 3_000_000_002, 0.2, trace=True, device=cuda)
    assert got["correct"], got["checks"]
    for m in metrics:
        assert got["metrics"][m]["value"] > 0, m
    if "threshold_device_share.denoise" in metrics:
        assert got["metrics"]["threshold_device_share.denoise"]["value"] \
            <= got["metrics"]["plain_device_share.denoise"]["value"]
