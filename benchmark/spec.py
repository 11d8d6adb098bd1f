"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``benchmark/traffic/<mix>.json``), its
limits (``benchmark/cells/<cell>.json``), the pipeline its mix names
(``benchmark/pipelines/<pipeline>.py``) and the reader of each per-layer
metric it reports (``benchmark/metrics/<metric>.py``).  Nothing here lists a
cell, a mix or a metric: a later change adds one by adding its files and its
entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its data files read
    from under ``root``.  Raises KeyError for an unknown cell and
    FileNotFoundError for a missing file."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "cells" / f"{name}.json").read_text())["limits"]
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and _reported_in(m, name)]
    return Cell(name, int(w["chips"]), cfg, mix, limits, e2e, per_layer)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pipeline(mix: dict):
    """The pipeline module that the mix names."""
    return load_module(HERE / "pipelines" / f"{mix['pipeline']}.py",
                       f"benchmark_pipeline_{mix['pipeline']}")


def metric_reader(name: str):
    """The ``read(ctx)`` of the per-layer metric ``name``."""
    return load_module(HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read
