"""The signal-sharded cell, ``modwt_db4_l5_sharded4.batch``: its files
load by name, its reference holds the whole-signal transform's columns,
its runs on the CPU (gloo ranks, cut sizes) pass where sound and come out
false for the bfloat16 control, for a forward that wraps each shard on
itself and for a call that raises, a set-up that fails ends every rank,
and its per-layer readers read windows worked by hand."""
from __future__ import annotations

import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch import parallel
from wavebench import control, core, tracing
from wavebench.reference import filters
from wavebench.reference import modwt as whole
from wavebench.reference import modwt_segment as ref

CELL = "modwt_db4_l5_sharded4.batch"
SEED = 4_294_967_311


def small(ranks: int = 4) -> core.Cell:
    """The cell over ``ranks`` ranks at (3, ranks · 2048), checked in
    blocks of 512 columns; every other setting as committed."""
    cell = core.load_cell(CELL)
    cell.config["mesh"] = {"signal": ranks}
    w = cell.workload
    w["rows"] = 3
    w["lengths"] = dict(w["lengths"], n=ranks * 2048)
    w["check"] = dict(w["check"], block=512)
    w["trace_calls"] = 3
    return cell


def test_the_cell_loads_from_its_files():
    cell = core.load_cell(CELL)
    assert cell.chips == 4 and cell.config["mesh"] == {"signal": 4}
    assert cell.config["reference"] == "wavebench/reference/modwt_segment.py"
    assert cell.workload["entry"] == "modwt_sharded"
    assert [m["name"] for m in cell.end_to_end] == [
        "samples_per_s.denoise", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "modwt_sharded_roofline", "hop_device_share.sharded4",
        "hops_per_call.sharded4", "device_idle.sharded4"]
    rows, n = cell.config["shape"]
    assert (cell.workload["rows"], cell.workload["lengths"]["n"]) == (rows, n)
    assert cell.config["shard"] == [rows, n // 4]
    for m in cell.per_layer:
        assert hasattr(core.metric_reader(m["name"]), "read")


@pytest.mark.parametrize("name,level,n,shards,block", [
    ("Daubechies 4", 5, 1024, 4, 100),
    ("Daubechies 4", 3, 512, 2, 1000),
    ("Daubechies 4", 5, 256, 4, 30),      # the halo, 217, passes a shard
    ("Haar", 4, 96, 3, 7),
])
def test_segments_are_the_whole_signals_columns(name, level, n, shards,
                                                block):
    f = filters.BY_NAME[name]
    x = torch.randn(3, n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(n + level))
    want = whole.modwt(x, f, level)
    h, s = ref.halo(f, level), n // shards
    for r in range(shards):
        before = torch.roll(x, h - r * s, dims=-1)[..., :h]
        got = ref.modwt_segment(x[..., r * s:(r + 1) * s], before, f, level,
                                block=block)
        torch.testing.assert_close(got, want[..., r * s:(r + 1) * s],
                                   rtol=0, atol=1e-13)
        part = ref.modwt_segment(x[..., r * s:(r + 1) * s], before, f, level,
                                 start=s // 3, width=s // 2, block=block)
        torch.testing.assert_close(
            part, want[..., r * s + s // 3:r * s + s // 3 + s // 2],
            rtol=0, atol=1e-13)


def test_the_reference_refuses_a_wrong_context():
    f = filters.BY_NAME["Daubechies 4"]
    with pytest.raises(ValueError):
        ref.modwt_segment(torch.zeros(2, 64), torch.zeros(2, 10), f, 2)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sound_readings_pass_and_the_control_fails(ranks):
    cell = small(ranks)
    limit = cell.workload["check"]["limits"]["modwt_err"]
    for seed in (SEED, SEED + 1):
        sound = control.reading(cell, seed, 0.05, torch.float32, "cpu")
        low = control.reading(cell, seed, 0.05, control.CONTROL, "cpu")
        assert sound["failed"] == 0 and sound["modwt_err"] <= limit, sound
        assert low["modwt_err"] > limit, low


def test_a_run_counts_the_whole_signal_and_reads_one_hop():
    cell = small()
    got = core.run(cell, SEED, 0.1, trace=False, device="cpu")
    assert got["correct"] and got["failed"] == 0, got
    traced = core.run(cell, SEED + 5, 0.05, trace=True, device="cpu")
    assert traced["correct"], traced
    assert traced["metrics"]["hops_per_call.sharded4"]["value"] == 1.0


def wrapped(fn):
    """The sharded forward with each rank's answer the circular MODWT of
    its own shard: the collectives still run, the neighbour's samples are
    left out."""
    def broken(x, wavelet, level, mesh, *args, **kwargs):
        out = fn(x, wavelet, level, mesh, *args, **kwargs)
        own = jt.modwt(x.to_local(), wavelet, level, method="direct")
        return type(out).from_local(own, mesh, out.placements,
                                    run_check=False)
    return broken


def test_a_forward_that_wraps_its_own_shard_is_not_correct(monkeypatch):
    monkeypatch.setattr(parallel, "modwt_sharded",
                        wrapped(parallel.modwt_sharded))
    got = core.run(small(2), SEED, 0.05, trace=False, device="cpu")
    assert got["correct"] is False, got["checks"]
    assert got["checks"]["modwt_err"]["value"] > 1e-2


def test_a_call_that_raises_fails_every_later_call(monkeypatch):
    """Rank 0's calls raise after the warm-up (their collectives run):
    the first failed call stops the others, the run ends, not correct."""
    real, calls = parallel.modwt_sharded, []

    def refused_after_warm_up(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("refused")
        return out

    monkeypatch.setattr(parallel, "modwt_sharded", refused_after_warm_up)
    got = core.run(small(2), SEED, 0.05, trace=False, device="cpu")
    assert got["failed"] == got["attempted"] > 0
    assert len(calls) == 2          # the warm-up and the first call
    assert got["correct"] is False
    assert "refused" in got["first_failure"]


def test_a_set_up_that_fails_ends_every_rank_at_once():
    """Every rank's set-up raises (a wavelet the reference has no taps
    for): the run raises, each rank closes its group, none is left."""
    import time

    cell = small(2)
    cell.config["wavelet"] = "Daubechies 5"
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        core.run(cell, SEED, 0.05, trace=False, device="cpu")
    assert time.perf_counter() - t0 < 30


# -- the per-layer readers on a window worked by hand -------------------------

def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1}


def sharded_window(matched: bool = True) -> list:
    """Two sharded calls, each a hop (the halo's copy, 4 µs, and NCCL's
    send/receive, 10 µs) and the forward's kernel, 86 µs: 14 of 100 µs of
    device time in the hops.  Unmatched: NCCL's launch is not among the
    host's enqueues."""
    events = [ev(tracing.WINDOW, "user_annotation", 0, 400)]
    for t in (0, 200):
        events += [
            ev(tracing.CALL, "user_annotation", t, 150),
            ev("jwave.sharded.modwt", "user_annotation", t + 1, 140),
            ev("jwave.sharded.halo", "user_annotation", t + 2, 40),
            ev("jwave.sharded.hop", "user_annotation", t + 3, 35),
            ev("cudaLaunchKernel", "cuda_runtime", t + 5, 3),
            ev("jwave.launch.modwt_fwd_ctx", "user_annotation", t + 50, 30),
            ev("cudaLaunchKernel", "cuda_runtime", t + 60, 3),
            ev("elementwise_copy", "kernel", t + 10, 4),
            ev("ncclDevKernel_SendRecv", "kernel", t + 20, 10),
            ev("jw_modwt_fwd_ctx_kernel", "kernel", t + 70, 86)]
        if matched:
            events.append(ev("cuLaunchKernelEx", "cuda_driver", t + 15, 3))
    return events


def read(metric: str, events: list):
    reading = core.Reading(core.load_cell(CELL), core.Window(),
                           tracing.parse(events))
    return core.metric_reader(metric).read(reading)


@pytest.mark.parametrize("matched", [True, False])
def test_hop_share_and_hops_per_call(matched):
    events = sharded_window(matched)
    share = read("hop_device_share.sharded4", events)
    # matched, the halo's copy counts with the hop; by name, NCCL's alone
    assert share == pytest.approx(14.0 if matched else 10.0)
    assert read("hops_per_call.sharded4", events) == 2 / 2


def test_roofline_is_the_shards_bound_over_busy_time():
    got = read("modwt_sharded_roofline", sharded_window())
    rows, n = 8, (1 << 29) // 4
    want_s = (4 * rows * n * 7 + 4 * rows * 217) / 3.35e12
    assert got == pytest.approx(100.0 * want_s * 2 / 200e-6)


def test_readers_find_nothing_without_the_programs_spans():
    events = [e for e in sharded_window()
              if not e["name"].startswith("jwave.sharded")]
    assert read("hop_device_share.sharded4", events) is None
    assert read("hops_per_call.sharded4", events) is None
