"""The import guard: nothing the benchmark runs imports JAX, flax or the JAX
package.  Names are compared by their top-level part, whole: the port,
``disco_tpu_torch``, begins with the JAX package's name and is not it."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "disco_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, f"{path.relative_to(ROOT)}: {name}"


def test_a_run_loads_no_jax_module(tmp_path):
    """Every module of the benchmark and a run of each cell on the CPU, in a
    fresh process: then no loaded module's top-level name is JAX's or the
    JAX package's."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import check, costs, faults, harness, scenes, spec, trace, weights
from benchmark.reference import crnn, dsp, tango
from benchmark.tests.tiny import write_tiny
from pathlib import Path
import importlib
root = write_tiny(Path({str(tmp_path)!r}))
bench = json.loads((root / "BENCHMARK.json").read_text())
for m in bench["per_layer"]:
    spec.metric_reader(m["name"])
for w in bench["workloads"]:
    cell = spec.load_cell(root, w["name"])
    harness.run_cell(cell, 2**31 + 5, 0.2, True, device="cpu")
run = importlib.import_module("benchmark.run")
print(json.dumps(sorted(sys.modules)))
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, flagged = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert "disco_tpu_torch" in loaded and "benchmark.harness" in loaded
    assert not [m for m in loaded if m.split(".", 1)[0] in FORBIDDEN]
    assert flagged == []


def test_the_runs_own_guard_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "disco_tpu_torchx", sys)
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".", 1)[0] in FORBIDDEN]
    monkeypatch.setitem(sys.modules, "disco_tpu.core.dsp", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    found = run.forbidden_modules()
    assert "disco_tpu.core.dsp" in found and "jaxlib" in found
    assert not [m for m in found if m.startswith("disco_tpu_torch")]
