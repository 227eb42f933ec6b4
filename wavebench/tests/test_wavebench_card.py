"""On the card: the cut cells run their timed paths (the port's kernels)
and pass, the control fails, and a folder holding only the manifest and
the benchmark prints no result.  Run on a machine with a card:
``python -m pytest wavebench/tests -m cuda -o addopts=""``."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from wavebench import control, core

from .helpers import CELLS, ROOT, small

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", CELLS)
def test_cut_cell_on_the_card(cuda, name):
    got = core.run(small(name), 3_000_000_001, 0.2, trace=True, device=cuda)
    assert got["correct"], got["checks"]
    assert got["device"]["busy_s"] > 0
    low = control.reading(small(name), 5, 0.05, control.CONTROL, cuda)
    limits = small(name).workload["check"]["limits"]
    assert all(low[k] > v for k, v in limits.items()), low


def test_bare_folder_prints_no_result(cuda, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "wavebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "wavebench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
