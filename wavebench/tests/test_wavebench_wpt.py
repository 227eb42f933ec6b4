"""The packet denoise cell (``wpt_sym8_l6.denoise``) and the round-trip cell
(``modwt_db4_l5.roundtrip``): the signals come again from the same seed,
sound runs pass and the bfloat16 control fails ``wpt_err``'s limit, a
denoise that skips its shrink is not correct, the open-packet rule admits
another basis only at a genuine near-tie, a round trip that hands back
its input is not correct, and the cells' readers read windows worked by
hand.  Cut to sizes a CPU test holds; the ``cuda`` test runs the cut
cells on the card."""
from __future__ import annotations

import math

import pytest
import torch

import jwave_pro_tpu_torch as jt
from wavebench import control, core, tracing
from wavebench.entries import wpt_denoise as entry
from wavebench.reference import wpt as ref

from .test_wavebench_spans import denoise_window, reading

CELL, ROUNDTRIP = "wpt_sym8_l6.denoise", "modwt_db4_l5.roundtrip"
SEED = 4_294_967_459


def cut(n: int = 4096, rows: int = 16, pool: int = 1) -> core.Cell:
    """The packet cell with its signals cut to ``n`` samples and ``rows`` a
    batch, and its pool to ``pool`` requests (one, so that the first call
    of the shortest window answers every sampled request); every other
    setting, the level and the limits included, as committed."""
    cell = core.load_cell(CELL)
    cell.config["n"] = n
    w = cell.workload
    w["rows"] = rows
    w["lengths"] = dict(w["lengths"], n=n, count=pool)
    w["trace_calls"] = 3
    return cell


def cut_roundtrip(pool: int = 1) -> core.Cell:
    cell = core.load_cell(ROUNDTRIP)
    w = cell.workload
    w["rows"] = 3
    w["lengths"] = dict(w["lengths"], n=2048, count=pool)
    w["trace_calls"] = 3
    return cell


def test_the_same_seed_makes_the_same_signals():
    spec = cut().workload["signal"]

    def made(seed):
        gen = torch.Generator().manual_seed(seed)
        return entry.signals(spec, 6, 4096, gen, "cpu")

    a, b, other = made(SEED), made(SEED), made(SEED + 1)
    assert a.dtype == torch.float32 and a.shape == (6, 4096)
    assert torch.equal(a, b) and not torch.equal(a, other)
    one = core.make_entry(cut(pool=4), SEED, "cpu")
    two = core.make_entry(cut(pool=4), SEED, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(one.inputs, two.inputs))
    assert one.order == two.order and one.rows == two.rows
    assert len(one.kept) == 2 and len(one.rows) == 8


def test_signals_are_the_test_signals_at_snr_7():
    n = 4096
    clean = entry.test_signals(n, "cpu")
    t = torch.arange(1, n + 1, dtype=torch.float64) / n
    # HeaviSine and Doppler from their formulas, Blocks' first jump
    torch.testing.assert_close(clean[2], 4 * torch.sin(4 * math.pi * t)
                               - torch.sign(t - 0.3) - torch.sign(0.72 - t))
    torch.testing.assert_close(clean[3], torch.sqrt(t * (1 - t)) * torch.sin(
        2.1 * math.pi / (t + 0.05)))
    assert float(clean[0][int(0.05 * n)]) == 0.0
    assert float(clean[0][int(0.11 * n)]) == 4.0
    assert float(clean[1].max()) == pytest.approx(5.1, abs=0.05)
    spec = dict(cut().workload["signal"], noise=0.0)
    quiet = entry.signals(spec, 64, n, torch.Generator().manual_seed(SEED),
                          "cpu").double()
    assert torch.allclose(quiet.std(-1), torch.full((64,), 7.0,
                          dtype=torch.float64), rtol=1e-6)
    # each row is one of the four, shifted
    scaled = clean * (7.0 / clean.std(-1, keepdim=True))
    for row in quiet[:8]:
        assert any(float((torch.roll(s, k) - row).abs().max()) < 1e-5
                   for s in scaled for k in range(n)
                   if abs(float(torch.roll(s, k)[0] - row[0])) < 1e-5)
    noisy = entry.signals(cut().workload["signal"], 64, n,
                          torch.Generator().manual_seed(SEED), "cpu")
    assert float((noisy.double() - quiet).std()) == pytest.approx(1.0,
                                                                  rel=0.01)


def test_lengths_must_be_the_configurations():
    cell = cut()
    cell.workload["lengths"]["n"] *= 2
    with pytest.raises(ValueError, match="configuration"):
        core.make_entry(cell, SEED, "cpu")


def test_sound_readings_pass_and_the_control_fails():
    cell = cut()
    limits = cell.workload["check"]["limits"]
    for seed in (SEED, SEED + 1):
        sound = control.reading(cell, seed, 0.05, torch.float32, "cpu")
        low = control.reading(cell, seed, 0.05, control.CONTROL, "cpu")
        assert sound["wpt_err"] <= limits["wpt_err"], sound
        assert 1 <= sound["wpt_bases"] <= limits["wpt_bases"], sound
        assert low["wpt_err"] > limits["wpt_err"], low


def test_a_denoise_that_skips_its_shrink_is_not_correct(monkeypatch):
    denoise = jt.wpt_denoise

    def unshrunk(x, wavelet, level=None, **kwargs):
        return denoise(x, wavelet, level, threshold=0.0, **kwargs)

    monkeypatch.setattr(jt, "wpt_denoise", unshrunk)
    got = core.run(cut(), SEED, 0.1, trace=False, device="cpu")
    assert got["correct"] is False, got["checks"]


def test_cut_cell_runs_on_the_cpu():
    got = core.run(cut(), 2_147_483_659, 0.1, trace=False, device="cpu")
    assert got["correct"] and got["failed"] == 0, got["checks"]
    assert set(got["checks"]) == {"wpt_err", "wpt_bases"}
    assert set(got["metrics"]) == {"samples_per_s", "peak_mem_gib",
                                   "setup_s"}


# -- the open-packet rule -----------------------------------------------------

def _split(level=3):
    """Every packet above the last level splits: one basis, the leaves."""
    return [torch.ones((1, 1 << l), dtype=torch.bool) for l in range(level)]


def test_bases_follow_the_open_packets():
    split = _split()
    shut = [torch.zeros_like(s) for s in split]
    count, masks = ref.bases(split, shut, 0)
    assert count == 1 and [m.tolist() for m in masks] == [
        [[False]], [[False, False]], [[False] * 4], [[True] * 8]]
    # an open packet that its ancestors reach: split or stay a leaf
    one = [s.clone() for s in shut]
    one[1][0, 1] = True
    count, masks = ref.bases(split, one, 0)
    assert count == 2 and masks[1][:, 1].tolist() == [True, False]
    # an open packet below a leaf is never reached
    leafy = [s.clone() for s in split]
    leafy[0][0, 0] = False
    count, _ = ref.bases(leafy, one, 0)
    assert count == 1
    # past MAX_BASES nothing is built
    every = [torch.ones_like(s) for s in split]
    count, masks = ref.bases(split, every, 0)
    assert count > ref.MAX_BASES and masks is None


def _near_tie(level=4, n=2048, seeds=range(40)):
    """A seeded float64 row with an open packet that its ancestors reach,
    and its tree, split, margins and open packets."""
    for seed in seeds:
        x = entry.signals(cut().workload["signal"], 4, n,
                          torch.Generator().manual_seed(seed), "cpu")
        tr = ref.tree(x, ref.SYMLET_8, level)
        split, margin = ref.choose([ref.sure(ref.packets(tr, l))
                                    for l in range(level + 1)])
        opened = [m.abs() <= s for m, s in zip(
            margin, ref.slack(ref.cost_bounds(tr, ref.SYMLET_8)))]
        for row in range(4):
            if ref.bases(split, opened, row)[0] > 1:
                return x[row:row + 1], tr[:, row:row + 1], split, margin, \
                    opened, row
    raise AssertionError("no near-tie among the seeds")


def _denoise_with(tr, split):
    masks = ref.leaves(split)
    return ref.synthesize(tr, masks, ref.threshold(tr), ref.SYMLET_8).float()


def test_the_rule_admits_only_a_genuine_near_tie():
    x, tr, split, margin, opened, row = _near_tie()
    split = [s[row:row + 1] for s in split]
    margin = [m[row:row + 1] for m in margin]
    opened = [o[row:row + 1] for o in opened]
    leaves = ref.leaves(split)
    reach = [(l, p) for l in range(len(split))
             for p in range(split[l].shape[1])
             if opened[l][0, p] and (leaves[l][0, p] or split[l][0, p])]
    limit = cut().workload["check"]["limits"]["wpt_err"]
    # the other choice at the open packet passes, as the float64 one does
    l, p = reach[0]
    other = [s.clone() for s in split]
    other[l][0, p] = ~other[l][0, p]
    for path in (split, other):
        err, count, _ = ref.error(_denoise_with(tr, path), x, ref.SYMLET_8,
                                  len(split))
        assert err <= limit and count >= 2, err
    # the other choice at a reached packet that is not open fails
    closed = [(l, p) for l in range(len(split))
              for p in range(split[l].shape[1])
              if not opened[l][0, p] and split[l][0, p]]
    assert closed
    l, p = max(closed, key=lambda lp: float(margin[lp[0]][0, lp[1]].abs()))
    wrong = [s.clone() for s in split]
    wrong[l][0, p] = False
    err, _, _ = ref.error(_denoise_with(tr, wrong), x, ref.SYMLET_8,
                          len(split))
    assert err > limit


# -- the round trip -----------------------------------------------------------

def test_cut_roundtrip_runs_on_the_cpu():
    got = core.run(cut_roundtrip(), 2_147_483_661, 0.1, trace=False,
                   device="cpu")
    assert got["correct"] and got["failed"] == 0, got["checks"]
    assert set(got["checks"]) == {"modwt_err"}
    assert set(got["metrics"]) == {"samples_per_s.denoise", "peak_mem_gib",
                                   "setup_s"}


@pytest.mark.parametrize("fault", ["returns_its_input", "forward_only",
                                   "inverse_of_nothing"])
def test_a_broken_round_trip_is_not_correct(monkeypatch, fault):
    level = cut_roundtrip().config["level"]
    if fault == "returns_its_input":
        # no transform at all: the input in the coefficients' place, and
        # the inverse hands back the input it was given
        monkeypatch.setattr(jt, "modwt", lambda x, *a, **k: x.expand(
            level + 1, *x.shape))
        monkeypatch.setattr(jt, "imodwt", lambda c, *a, **k: c[0])
    elif fault == "forward_only":
        monkeypatch.setattr(jt, "imodwt", lambda c, *a, **k: c[-1])
    else:
        monkeypatch.setattr(jt, "imodwt", lambda c, *a, **k: c[0] * 0)
    got = core.run(cut_roundtrip(), SEED, 0.1, trace=False, device="cpu")
    assert got["correct"] is False, got["checks"]


# -- the readers --------------------------------------------------------------

def busy_window(calls: int, busy_us: float) -> tracing.Trace:
    return tracing.Trace(0.0, 2 * busy_us, [("k", "kernel", 0.0, busy_us)],
                         [], calls)


def test_wpt_roofline_is_the_call_bound_over_busy_time():
    cell = core.load_cell(CELL)
    reader = core.metric_reader("wpt_denoise_roofline")
    t = reader.call_bound(1024, 65536, 6, 16)
    assert t == pytest.approx((1 << 26) * 415 / 67e12, rel=1e-12)
    got = reader.read(core.Reading(cell, core.Window(),
                                   busy_window(24, 24 * 50e3)))
    assert got == pytest.approx(100 * t / 50e-3, rel=1e-9)
    assert reader.read(core.Reading(cell, core.Window(),
                                    busy_window(24, 0))) is None
    other = core.load_cell("modwt_db4_l5.batch")
    assert reader.read(core.Reading(other, core.Window(),
                                    busy_window(3, 10.0))) is None


def test_roundtrip_roofline_adds_the_inverse_to_the_forward():
    cell = core.load_cell(ROUNDTRIP)
    reader = core.metric_reader("modwt_roundtrip_roofline")
    t = reader.call_bound(8, 1 << 20, 5, 8)
    assert t == pytest.approx(2 * 4 * 8 * (1 << 20) * 7 / 3.35e12,
                              rel=1e-12)
    got = reader.read(core.Reading(cell, core.Window(),
                                   busy_window(300, 300 * 250.0)))
    assert got == pytest.approx(100 * t / 250e-6, rel=1e-9)
    other = core.load_cell("modwt_db4_l5.batch")
    assert reader.read(core.Reading(other, core.Window(),
                                    busy_window(3, 10.0))) is None


def _basis_window(**kwargs):
    return [dict(e, name="jwave.wpt.basis")
            if e["name"] == "jwave.denoise.threshold" else e
            for e in denoise_window(**kwargs)]


def test_basis_share_reads_the_basis_spans():
    reader = core.metric_reader("basis_device_share.wpt")
    # the sort, fill and median, 30 + 2 + 20 µs, of 212 µs matched
    assert reader.read(reading(CELL, _basis_window())) == pytest.approx(
        100 * 52 / 212)
    # the threshold's span is not the basis's
    assert reader.read(reading(CELL, denoise_window())) is None
    assert reader.read(reading(CELL, _basis_window(
        drop="cudaMemsetAsync"))) is None
    # the threshold reader still reads its own span
    threshold = core.metric_reader("threshold_device_share.denoise")
    assert threshold.read(reading(CELL, denoise_window())) == \
        pytest.approx(100 * 52 / 212)


def test_idle_share_is_device_idle():
    from wavebench.metrics import device_idle

    assert core.metric_reader("device_idle.wpt").read is device_idle.read


def test_the_manifest_lists_the_cells_where_they_are_read():
    cell = core.load_cell(CELL)
    assert [m["name"] for m in cell.per_layer] == [
        "wpt_denoise_roofline", "basis_device_share.wpt", "device_idle.wpt"]
    assert [m["name"] for m in cell.end_to_end] == [
        "samples_per_s", "peak_mem_gib", "setup_s"]
    assert {m["moves"] for m in cell.per_layer} == {"samples_per_s"}
    # the round trip's set spreads (0.55%, 0.18%) pass a fifth of
    # samples_per_s's bound: its rate is filed under the 15% split
    trip = core.load_cell(ROUNDTRIP)
    assert [m["name"] for m in trip.per_layer] == ["modwt_roundtrip_roofline"]
    assert [m["name"] for m in trip.end_to_end] == [
        "samples_per_s.denoise", "peak_mem_gib", "setup_s"]
    assert {m["moves"] for m in trip.per_layer} == {"samples_per_s.denoise"}
    assert cell.chips == trip.chips == 1


@pytest.mark.cuda
def test_cut_cells_on_the_card(cuda):
    for cell in (cut(n=65536, rows=32), cut_roundtrip()):
        got = core.run(cell, 3_000_000_001, 0.2, trace=True, device=cuda)
        assert got["correct"], got["checks"]
        names = {m["name"] for m in cell.per_layer}
        assert set(got["metrics"]) == names, got["metrics"]
        for key, m in got["metrics"].items():
            if key.endswith("_roofline"):
                assert 0 < m["value"] < 100, (key, m)
    low = control.reading(cut(n=65536, rows=32), 5, 0.05, control.CONTROL,
                          cuda)
    assert low["wpt_err"] > cut().workload["check"]["limits"]["wpt_err"]
