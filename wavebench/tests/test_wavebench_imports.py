"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from wavebench import core

HERE = Path(core.__file__).resolve().parent


def imported(path: Path) -> set[str]:
    """Top-level names of the modules a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_source_imports_jax(path):
    assert not imported(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "math", "numpy", "torch"}


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "jwave_pro_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert core.forbidden_modules() == ["jax.numpy"]


def test_a_run_loads_no_jax():
    """Every module of the benchmark, and the program through it, in a
    fresh process: none of JAX's names in ``sys.modules`` after."""
    code = (
        "import importlib, json, sys; sys.path.insert(0, %r)\n"
        "from wavebench import core, control, sets, traffic, tracing\n"
        "for m in ('modwt', 'cwt', 'modwt_denoise', 'stream_update'):\n"
        "    importlib.import_module('wavebench.entries.' + m)\n"
        "for p in sorted((core.HERE / 'metrics').glob('*.py')):\n"
        "    core.metric_reader(p.stem)\n"
        "print(json.dumps(core.forbidden_modules()))\n"
    ) % str(HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
