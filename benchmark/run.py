"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its pieces are found by name under ``benchmark/`` (see
``benchmark/README.md``).  The last line of standard output is the result's
JSON object; the last lines of standard error give each number compared with
its limit.  Without a CUDA device, or with fewer than the cell asks for, the
run prints no result and exits with 2; if JAX or the JAX package is loaded
in this process when the run is over, it exits with 3.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the script's own folder is not a place to import from: its modules are
# ``benchmark.*``, and a bare ``trace`` or ``check`` there would shadow others
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
FORBIDDEN = ("jax", "jaxlib", "flax", "disco_tpu")


def _process_start() -> float:
    """The wall-clock time this process started (``/proc``; now elsewhere)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
T_SCRIPT = time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``disco_tpu_torch`` is not ``disco_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the kernels' build cache at a fixed path inside the checkout
    os.environ["DISCO_TORCH_COMPILE_CACHE"] = str(ROOT / "build" / "kernels")
    # and the bytecode of every module the run imports, torch's too: an
    # environment that writes none (PYTHONDONTWRITEBYTECODE) otherwise has
    # each run compile torch's sources anew, most of a warm set-up
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    marks = [("interpreter", T_SCRIPT), ("torch", time.time())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell asks for {cell.chips} CUDA device(s); {n} available",
              file=sys.stderr)
        return 2
    marks.append(("driver", time.time()))
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_process=T_START, marks=marks)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, n in result["checks"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
