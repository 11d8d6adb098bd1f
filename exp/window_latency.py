#!/usr/bin/env python3
"""The streaming window's latency, alone in its process, on the card.

Builds ``chip_smoke.py``'s north-star scene (K=8 nodes x C=4 mics, 10 s at
16 kHz, seed 0), runs window 1 through ``streaming_clip_fused(...,
solver='jacobi-pallas', blocks_per_dispatch=16)`` for its state, runs
windows 2-9 once untimed, then times windows 2-9 from that state
``--rounds`` times, each on the host clock to its synchronize, as
``chip_smoke.py``'s phase 5 does but with nothing else in the process.
Prints one JSON object: the card, the tree, the median and every latency
in ms.

    python3 exp/window_latency.py [--tree PATH] [--rounds N]

``--tree`` runs another checkout's ``disco_tpu_torch`` (its kernels built
under that checkout) with this checkout's scene and timing, so that two
trees are compared in alternating processes.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("window_latency: needs a GPU", file=sys.stderr)
        return 1
    import disco_tpu_torch

    assert Path(disco_tpu_torch.__file__).resolve().is_relative_to(tree), disco_tpu_torch.__file__
    dev = torch.device("cuda")
    y, s, n = smoke.scene(smoke.K, smoke.C, int(smoke.DUR_S * smoke.FS),
                          noise_scale=smoke.NOISE_SCALE)
    d = SimpleNamespace(**{k: torch.from_numpy(a).to(dev) for k, a in zip("ysn", (y, s, n))})
    _, (state1,) = smoke.stream_windows(d, 0, 1, None)
    smoke.stream_windows(d, 1, smoke.N_WINDOWS, state1)
    torch.cuda.synchronize()
    lat = []
    for _ in range(args.rounds):
        state = state1
        for w in range(1, smoke.N_WINDOWS):
            t0 = time.perf_counter()
            _, (state,) = smoke.stream_windows(d, w, w + 1, state)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "tree": str(tree), "median_ms": sorted(lat)[len(lat) // 2],
                      "latency_ms": lat}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
