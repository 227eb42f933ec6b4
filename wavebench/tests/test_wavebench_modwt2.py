"""The 2D denoise cell (``modwt2_db4_l3.denoise``): the frames come again
from the same seed, sound runs pass and the bfloat16 control fails
``denoise2_err``'s limit, a broken denoise is not correct, and the
cell's readers read windows worked by hand.  Cut to sizes a CPU test
holds; the ``cuda`` test runs the cut cell on the card."""
from __future__ import annotations

import pytest
import torch

import jwave_pro_tpu_torch as jt
from wavebench import control, core, tracing
from wavebench.entries import modwt2_denoise as entry

from .test_wavebench_spans import denoise_window, reading

CELL = "modwt2_db4_l3.denoise"
SEED = 4_294_967_377


def cut(frame=(64, 96), rows: int = 3, pool: int = 1) -> core.Cell:
    """The cell with its frames cut to ``frame`` and ``rows`` a stack, and
    its pool to ``pool`` requests (one, so that the first call of the
    shortest window answers every sampled request); every other setting,
    the limits included, as committed."""
    cell = core.load_cell(CELL)
    w = cell.workload
    w["rows"] = rows
    w["frame"] = list(frame)
    w["lengths"] = dict(w["lengths"], n=frame[0] * frame[1], count=pool)
    w["signal"] = dict(w["signal"], spots=[5, 9])
    w["trace_calls"] = 3
    return cell


def test_the_same_seed_makes_the_same_frames():
    spec = cut().workload["signal"]

    def made(seed):
        gen = torch.Generator().manual_seed(seed)
        return entry.frames(spec, 3, (64, 96), gen, "cpu")

    a, b, other = made(SEED), made(SEED), made(SEED + 1)
    assert a.dtype == torch.float32 and a.shape == (3, 64, 96)
    assert torch.equal(a, b) and not torch.equal(a, other)
    one = core.make_entry(cut(pool=4), SEED, "cpu")
    two = core.make_entry(cut(pool=4), SEED, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(one.inputs, two.inputs))
    assert one.order == two.order and one.images == two.images
    assert len(one.kept) == 2 and len(one.images) == 2


def test_frames_are_spots_on_a_background_with_noise():
    spec = dict(cut().workload["signal"], spots=[40, 40], noise=0.0)
    gen = torch.Generator().manual_seed(SEED)
    quiet = entry.frames(spec, 2, (128, 128), gen, "cpu")
    lo, hi = spec["background"]
    # no noise: at least the background, and the spots rise above it
    assert float(quiet.min()) >= lo
    assert float(quiet.max()) >= lo + spec["brightness"][0] * 0.5
    gen = torch.Generator().manual_seed(SEED)
    noisy = entry.frames(dict(spec, noise=0.1), 2, (128, 128), gen, "cpu")
    sd = float((noisy.double() - quiet.double()).std())
    assert 0.1 * spec["brightness"][0] < sd < 0.1 * spec["brightness"][1]


def test_lengths_must_be_the_frames_pixels():
    cell = cut()
    cell.workload["lengths"]["n"] += 1
    with pytest.raises(ValueError, match="pixels"):
        core.make_entry(cell, SEED, "cpu")


def test_sound_readings_pass_and_the_control_fails():
    cell = cut()
    limit = cell.workload["check"]["limits"]["denoise2_err"]
    for seed in (SEED, SEED + 1):
        sound = control.reading(cell, seed, 0.05, torch.float32, "cpu")
        low = control.reading(cell, seed, 0.05, control.CONTROL, "cpu")
        assert sound["denoise2_err"] <= limit, sound
        assert low["denoise2_err"] > limit, low


def altered(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out.view(-1)[out.numel() // 3] += 50.0
        return out
    return broken


@pytest.mark.parametrize("fault", [altered, lambda fn: (
    lambda x, *a, **k: x.clone())], ids=["altered", "identity"])
def test_a_broken_denoise_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(jt, "modwt2_denoise", fault(jt.modwt2_denoise))
    # every frame compared, so an altered pixel is always among them
    cell = cut()
    cell.workload["check"] = dict(cell.workload["check"], images=3)
    got = core.run(cell, SEED, 0.1, trace=False, device="cpu")
    assert got["correct"] is False, got["checks"]


def test_cut_cell_runs_on_the_cpu():
    got = core.run(cut(), 2_147_483_659, 0.1, trace=False, device="cpu")
    assert got["correct"] and got["failed"] == 0, got["checks"]
    assert set(got["metrics"]) == {"samples_per_s", "peak_mem_gib",
                                   "setup_s"}


def busy_window(calls: int, busy_us: float) -> tracing.Trace:
    """A traced window of ``calls`` calls whose device was busy
    ``busy_us`` µs."""
    return tracing.Trace(0.0, 2 * busy_us, [("k", "kernel", 0.0, busy_us)],
                         [], calls)


def test_roofline_is_the_call_bound_over_busy_time():
    cell = core.load_cell(CELL)
    reader = core.metric_reader("modwt2_denoise_roofline")
    assert reader.call_bound(16, (2048, 2048), 3, 8) == pytest.approx(
        0.604e-3, rel=1e-3)
    got = reader.read(core.Reading(cell, core.Window(),
                                   busy_window(60, 60 * 18e3)))
    assert got == pytest.approx(100 * 0.603979776 / 18, rel=1e-9)
    # no busy time, or another cell's entry: nothing to read
    assert reader.read(core.Reading(cell, core.Window(),
                                    busy_window(60, 0))) is None
    other = core.load_cell("modwt_db4_l5.batch")
    assert reader.read(core.Reading(other, core.Window(),
                                    busy_window(3, 10.0))) is None


def test_shrink_share_reads_the_shrink_spans():
    reader = core.metric_reader("shrink_device_share.denoise2")
    # the shrink kernels, 10 + 10 µs, of 212 µs matched to their enqueues
    got = reader.read(reading(CELL, denoise_window()))
    assert got == pytest.approx(100 * 20 / 212)
    # no shrink span (a program that shrinks inside a kernel or opens no
    # span): nothing to read
    assert reader.read(reading(CELL, denoise_window(
        drop="jwave.denoise.shrink"))) is None
    # operations that cannot be matched to their enqueues: nothing either
    assert reader.read(reading(CELL, denoise_window(
        drop="cudaMemsetAsync"))) is None


def test_idle_share_is_device_idle():
    from wavebench.metrics import device_idle

    assert core.metric_reader("device_idle.denoise2").read is \
        device_idle.read


def test_the_manifest_lists_the_cell_where_it_is_read():
    cell = core.load_cell(CELL)
    assert [m["name"] for m in cell.per_layer] == [
        "modwt2_denoise_roofline", "shrink_device_share.denoise2",
        "device_idle.denoise2"]
    assert [m["name"] for m in cell.end_to_end] == [
        "samples_per_s", "peak_mem_gib", "setup_s"]
    assert {m["moves"] for m in cell.per_layer} == {"samples_per_s"}
    assert cell.chips == 1


@pytest.mark.cuda
def test_cut_cell_on_the_card(cuda):
    cell = cut(frame=(512, 512), rows=2)
    got = core.run(cell, 3_000_000_001, 0.2, trace=True, device=cuda)
    assert got["correct"], got["checks"]
    names = {m["name"] for m in cell.per_layer}
    assert set(got["metrics"]) == names, got["metrics"]
    for key, m in got["metrics"].items():
        if key.endswith("_roofline"):
            assert 0 < m["value"] < 100, (key, m)
    low = control.reading(cell, 5, 0.05, control.CONTROL, cuda)
    limits = cell.workload["check"]["limits"]
    assert all(low[k] > v for k, v in limits.items()), low
