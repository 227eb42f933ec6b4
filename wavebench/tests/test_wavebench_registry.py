"""Cells, configurations and per-layer metrics are files found by name: a
new one of each is added as files alone, no file that exists edited."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from wavebench import core
from wavebench.metrics import device_idle

from .helpers import CELLS, ROOT, small


def test_manifest_names_a_file_for_everything():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config in spec["configs"]:
        assert (ROOT / config["file"]).is_file()
    for cell in spec["workloads"]:
        assert core.load_cell(cell["name"]).workload["entry"]
    for metric in spec["per_layer"]:
        assert hasattr(core.metric_reader(metric["name"]), "read")
    assert [c["name"] for c in spec["workloads"]] == list(CELLS)


def test_a_new_cell_configuration_and_metric_as_files(tmp_path):
    here = tmp_path / "wavebench"
    shutil.copytree(core.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a configuration: Db4 at three levels
    config = json.loads((here / "configs" / "modwt_db4_l5.json").read_text())
    (here / "configs" / "modwt_db4_l3.json").write_text(json.dumps(
        dict(config, level=3)))
    spec["configs"].append({"name": "modwt_db4_l3", "source": "x",
                            "file": "wavebench/configs/modwt_db4_l3.json",
                            "reduced": [], "why": "x"})
    # a cell: the round of the batch cell at (4, 4096) on it
    (here / "workloads" / "modwt_db4_l3.small.json").write_text(json.dumps({
        "config": "modwt_db4_l3", "traffic": "small", "entry": "modwt",
        "loop": "closed", "rows": 4,
        "lengths": {"kind": "fixed", "n": 4096, "count": 2},
        "signal": {"kind": "gaussian"},
        "check": {"sample": 2, "limits": {"modwt_err": 1e-4}},
        "trace_calls": 3}))
    spec["workloads"].append({"name": "modwt_db4_l3.small",
                              "config": "modwt_db4_l3", "traffic": "small",
                              "chips": 1, "why": "x"})
    # a per-layer metric: the traced calls
    (here / "metrics" / "calls.traced.py").write_text(
        "def read(r):\n    return float(r.trace.calls)\n")
    spec["per_layer"].append({"name": "calls.traced", "unit": "count",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "samples_per_s",
                              "workloads": ["modwt_db4_l3.small"]})
    # and the cell reports existing quantities, split off by their names
    (here / "metrics" / "device_idle.small.py").write_text(
        "from wavebench.metrics.device_idle import read  # noqa: F401\n")
    spec["end_to_end"].append({"name": "samples_per_s.small",
                               "unit": "samples/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["modwt_db4_l3.small"]})
    spec["per_layer"].append({"name": "device_idle.small", "unit": "%",
                              "better": "lower", "source": "device_trace",
                              "layer": "device",
                              "moves": "samples_per_s.small",
                              "workloads": ["modwt_db4_l3.small"]})
    manifest = tmp_path / "BENCHMARK.json"
    manifest.write_text(json.dumps(spec))
    cell = core.load_cell("modwt_db4_l3.small", manifest=manifest, here=here)
    assert cell.config["level"] == 3
    assert [m["name"] for m in cell.per_layer] == ["calls.traced",
                                                   "device_idle.small"]
    assert [m["name"] for m in cell.end_to_end] == [
        "peak_mem_gib", "setup_s", "samples_per_s.small"]
    got = core.run(cell, 11, 0.2, trace=False, device="cpu")
    assert got["correct"], got["checks"]
    assert got["metrics"]["samples_per_s.small"]["value"] > 0
    traced = core.run(cell, 12, 0.1, trace=True, device="cpu")
    assert traced["metrics"]["calls.traced"]["value"] == 3.0
    assert core.metric_reader("device_idle.small", here).read is \
        device_idle.read
    # the existing cells still load from the copied folder
    for name in CELLS:
        core.load_cell(name, manifest=manifest, here=here)


def test_a_cell_whose_file_disagrees_is_refused(tmp_path):
    here = tmp_path / "wavebench"
    shutil.copytree(core.HERE / "configs", here / "configs")
    (here / "workloads").mkdir()
    w = json.loads((core.HERE / "workloads" / "modwt_db4_l5.batch.json")
                   .read_text())
    (here / "workloads" / "modwt_db4_l5.batch.json").write_text(
        json.dumps(dict(w, traffic="other")))
    with pytest.raises(ValueError):
        core.load_cell("modwt_db4_l5.batch", here=here)
    with pytest.raises(KeyError):
        core.load_cell("no.such_cell")


def test_cut_cells_run_on_the_cpu():
    for name in CELLS:
        got = core.run(small(name), 2_147_483_659, 0.1, trace=False,
                       device="cpu")
        assert got["correct"], (name, got["checks"])
        assert list(got)[-1] == "checks"
        assert got["attempted"] > 0 and got["failed"] == 0


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without a card the run says so and exits non-zero, also in a
    folder that holds only the manifest and the benchmark."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for where in (ROOT, tmp_path):
        if where is tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(core.HERE, tmp_path / "wavebench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        proc = subprocess.run(
            [sys.executable, str(where / "wavebench" / "run.py"),
             "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keeps_its_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    e2e = spec["end_to_end"]
    for m in e2e + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for name in cells:
        reported = {m["name"] for m in e2e
                    if name in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in spec["per_layer"]
                  if name in m.get("workloads", cells)]
        assert layers
        for m in layers:        # each moves a metric its cells report
            assert m["moves"] in reported, (name, m["name"])
    for c in spec["configs"] + spec["workloads"]:
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
