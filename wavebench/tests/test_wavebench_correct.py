"""What decides ``correct``: sound runs pass, the lower-precision control
fails, and a run whose timed path is broken underneath comes out false,
once for each fault a cell can have.  The runs skip the look for a card
and use the cells' committed limits at sizes a CPU test holds."""
from __future__ import annotations

import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch import streaming
from wavebench import control, core

from .helpers import CELLS, small

SEED = 4_294_967_311


@pytest.mark.parametrize("name", CELLS)
def test_sound_readings_pass_and_the_control_fails(name):
    cell = small(name)
    limits = cell.workload["check"]["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        sound = control.reading(cell, seed, 0.05, torch.float32, "cpu")
        low = control.reading(cell, seed, 0.05, control.CONTROL, "cpu")
        for key, limit in limits.items():
            assert sound[key] <= limit, (key, sound)
            assert low[key] > limit, (key, low)


def half_batch(fn):
    """The call on the first half of the rows; the rest copies it."""
    axis = 1 if fn is jt.modwt else 0      # modwt's rows are its axis 1

    def broken(x, *args, **kwargs):
        out = fn(x[: x.shape[0] // 2], *args, **kwargs)
        out = out.coefficients if hasattr(out, "coefficients") else out
        return torch.cat([out, out], dim=axis).narrow(axis, 0, x.shape[0])
    return broken


def altered(fn):
    """The call with one answer changed where it is produced."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        out = out.coefficients if hasattr(out, "coefficients") else out
        out = out.clone()
        out.view(-1)[out.numel() // 3] += 1.0
        return out
    return broken


def identity(fn):
    """A denoise that hands back its input."""
    return lambda x, *args, **kwargs: x.clone()


class Result:
    def __init__(self, coefficients):
        self.coefficients = coefficients


def as_result(wrap):
    """A CWT fault keeps ``cwt``'s return type."""
    return lambda fn: (lambda *a, **k: Result(wrap(fn)(*a, **k)))


FAULTS = {
    "modwt_half_batch": ("modwt_db4_l5.batch", "modwt", half_batch),
    "modwt_altered": ("modwt_db4_l5.batch", "modwt", altered),
    "cwt_half_batch": ("cwt_morlet6_s64.batch", "cwt",
                       as_result(half_batch)),
    "cwt_altered": ("cwt_morlet6_s64.batch", "cwt", as_result(altered)),
    "denoise_half_batch": ("modwt_db4_l5.denoise", "modwt_denoise",
                           half_batch),
    "denoise_altered": ("modwt_db4_l5.denoise", "modwt_denoise", altered),
    "denoise_identity": ("modwt_db4_l5.denoise", "modwt_denoise", identity),
}


@pytest.mark.parametrize("name,fn,fault", FAULTS.values(), ids=FAULTS)
def test_a_broken_call_is_not_correct(monkeypatch, name, fn, fault):
    monkeypatch.setattr(jt, fn, fault(getattr(jt, fn)))
    got = core.run(small(name), SEED, 0.1, trace=False, device="cpu")
    assert got["correct"] is False, got["checks"]


def unchanged(update):
    """An update that returns the stream's state as it was."""
    def broken(self, samples):
        if getattr(self, "_frozen", None) is None:
            self._frozen = update(self, samples)
        return self._frozen
    return broken


def altered_update(update):
    def broken(self, samples):
        out = update(self, samples).clone()
        out[0, -1] += 1.0
        return out
    return broken


@pytest.mark.parametrize("fault", [unchanged, altered_update])
def test_a_broken_stream_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(streaming.StreamingMODWT, "update",
                        fault(streaming.StreamingMODWT.update))
    got = core.run(small("modwt_db4_l5.stream"), SEED, 0.1, trace=False,
                   device="cpu")
    assert got["correct"] is False, got["checks"]


def test_a_call_that_raises_is_counted(monkeypatch):
    modwt, calls = jt.modwt, []

    def refused_after_warm_up(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:          # set-up warms the one shape first
            raise RuntimeError("refused")
        return modwt(*args, **kwargs)

    monkeypatch.setattr(jt, "modwt", refused_after_warm_up)
    got = core.run(small("modwt_db4_l5.batch"), SEED, 0.05, trace=False,
                   device="cpu")
    assert got["failed"] == got["attempted"] > 0
    assert got["correct"] is False
    assert "refused" in got["first_failure"]
