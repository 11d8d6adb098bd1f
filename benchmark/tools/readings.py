"""The readings that a cell's limits are set from, in one process on the card.

    python3 benchmark/tools/readings.py --workload <cell> [--seeds 12]
        [--fault-seeds 3] [--seconds 1] [--out <file.json>]

For each of ``--seeds`` seeds, a short run of the cell's timed path at its own
size (set-up, a window of ``--seconds``, the check of the sampled batches),
and the number compared; then, on ``--fault-seeds`` other seeds each, the
control (the reference in float32 with TF32 allowed, in the program's place),
the program with TF32 allowed, the program's bf16 lane, and each planted
fault of ``benchmark/faults.py``.  Prints one JSON line a run and writes them
all to ``--out``.  The limit goes between the largest sound reading and the
smallest control reading (see PERF.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

SEED0 = 2 ** 31 + 1009


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import os
    os.environ.setdefault("DISCO_TORCH_COMPILE_CACHE", str(ROOT / "build" / "kernels"))
    import torch

    from benchmark import faults, harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    bf16 = dataclasses.replace(cell, mix=dict(cell.mix, precision="bf16"))
    plan = [("program", cell, None, SEED0 + 7919 * i) for i in range(args.seeds)]
    extra = [("control", cell, faults.control), ("program_tf32", cell, faults.program_tf32),
             ("program_bf16", bf16, None)] + [(k, cell, f) for k, f in faults.FAULTS.items()]
    for j, (name, c, var) in enumerate(extra):
        plan += [(name, c, var, SEED0 + 104729 * (j + 1) + 7919 * i)
                 for i in range(args.fault_seeds)]
    rows = []
    quiet = open(os.devnull, "w")
    for name, c, var, seed in plan:
        t = time.time()
        row = {"cell": cell.name, "variant": name, "seed": seed}
        try:
            res = harness.run_cell(c, seed, args.seconds, False, "cuda", variant=var,
                                   log=quiet)
            row.update(err_worst=res["checks"]["err_worst"]["value"], correct=res["correct"],
                       batches=res["attempted"] // c.mix["batch_clips"])
        except Exception:  # a variant that crashes has failed: record it, go on
            row["error"] = traceback.format_exc(limit=3)[-600:]
        row["s"] = round(time.time() - t, 2)
        row["card"] = torch.cuda.get_device_name(0)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    quiet.close()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
