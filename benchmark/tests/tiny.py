"""The tiny copy of the benchmark's data that the CPU tests run: both cells
at K = 2 nodes of C = 2 mics, 0.25-s clips, 2 clips a batch."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: the tiny sizes the CPU runs take in place of the cells' own
TINY_CFG = {"nodes": 2, "mics_per_node": 2}
TINY_MIX = {"batch_clips": 2, "clip_s": 0.25, "pool_batches": 2, "check_batches": 1,
            "trace_batches": 2}


def write_tiny(dst: Path, cfg=None, mix=None, limit: float = 1e-3) -> Path:
    """A root holding ``BENCHMARK.json`` and the benchmark's configurations,
    mixes and cell files cut to the tiny sizes (``cfg``/``mix``: further
    overrides); returns ``dst``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "cells"):
        (dst / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        data.update(TINY_CFG, **(cfg or {}))
        (dst / c["file"]).write_text(json.dumps(data))
    for w in bench["workloads"]:
        data = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        data.update(TINY_MIX, **(mix or {}))
        (dst / "benchmark" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(data))
        (dst / "benchmark" / "cells" / f"{w['name']}.json").write_text(
            json.dumps({"limits": {"err_worst": limit}}))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
