#!/usr/bin/env python3
"""A fresh ``disco-serve`` process and its first session, run again and again.

The first block a new server process dispatches pays the card's start-up
(CUDA context, the kernel library, the libraries' handles): seconds, while
the next blocks wait in the queue.  With the degradation ladder on (the
CLI's default) those waits take it to its shed rung, which parks the only
session and tells its client to come back after ``retry_after_s``.  This
script starts ``python -m disco_tpu_torch.cli.serve`` as ``chip_smoke.py``'s
phase 3k does, streams the north-star clip (K=8 nodes x C=4 mics, 10 s,
626 frames, 64-frame blocks, ``jacobi-pallas``) through one client session,
and reports for each run whether the stream finished bit-identical to the
offline ``streaming_tango``, how many times the client reattached, and,
for a run that failed, the server's post-mortem.  ``--hold-gb`` keeps that
much device memory allocated in this process during a run, as earlier
phases of ``chip_smoke.py`` may.

    PYTHONPATH=. python3 exp/serve_cold_start_probe.py --runs 4   # on the card, ~1.5 min
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from disco_tpu_torch.core.masks import tf_mask_mag  # noqa: E402
from disco_tpu_torch.ops import stft_ops  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--hold-gb", type=float, nargs="*", default=[],
                   help="device memory held during the runs after the first --runs")
    args = p.parse_args()
    d = SimpleNamespace(dev=torch.device("cuda"), L=int(cs.DUR_S * cs.FS))
    x = torch.stack([torch.from_numpy(a).to(d.dev)
                     for a in cs.scene(cs.K, cs.C, d.L, noise_scale=cs.NOISE_SCALE)])
    spec, mag = stft_ops.stft_matmul(x, with_mag=True)
    d.Y, d.m = spec[0], tf_mask_mag(mag[1][:, 0], mag[2][:, 0], "irm1")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    runs = []
    for hold_gb in [0.0] * args.runs + list(args.hold_gb):
        hold = (torch.empty(int(hold_gb * 2**30), dtype=torch.uint8, device=d.dev)
                if hold_gb else None)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="cli-", dir=build) as tmp:
            try:
                out, ok = cs.cli_serve(d, Path(tmp)), True
            except Exception as e:  # the post-mortem is printed above
                traceback.print_exc()
                out, ok = {"error": f"{type(e).__name__}: {e}"[:300]}, False
        runs.append({"hold_gb": hold_gb, "ok": ok, "s": time.perf_counter() - t0, **out})
        print(f"run {json.dumps(runs[-1])}", flush=True)
        del hold
        torch.cuda.empty_cache()
    print(json.dumps({"runs": len(runs), "passed": sum(r["ok"] for r in runs),
                      "reattaches": [r.get("reattaches") for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
