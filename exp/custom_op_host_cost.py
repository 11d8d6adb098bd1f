#!/usr/bin/env python3
"""Host cost of a checkout's kernel wrappers on the card: one streaming
window and one serve block's dispatch on the host clock, and the host time
of one call of each kernel's wrapper.

Run it on two checkouts in one call to compare them on one card — the tree
before its kernels became named torch ops and the tree after (unpack the
older commit with ``git archive`` into a directory ``.gitignore`` lists),
alternating which runs first:

    python3 exp/custom_op_host_cost.py --root build/parent --label parent
    python3 exp/custom_op_host_cost.py --root . --label change

Each run prints one JSON line.  The window is the north-star one of
``chip_smoke.py`` phase 4 (K=8 nodes x C=4 mics, 16128 samples = 64
frames = 16 refresh blocks, ``streaming_clip_fused`` with
``solver='jacobi-pallas'``, state carried), timed to its synchronize; the
serve block is one 64-frame ``streaming_tango`` call with state (phase
3h's block), timed to its return (the dispatch) and to its synchronize.
Medians of 9 after a warm-up.  In a tree whose kernels are torch ops,
each timed window alternates with one whose STFT and eigensolver wrappers
launch past the dispatcher (``window_direct_ms``: the same launches, no
op).  Last, the host time of one call of each kernel's wrapper at a small
shape (2000 calls, no synchronize between).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

K, C, LW, BLOCK, U, RUNS = 8, 4, 16128, 64, 4, 9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="the checkout whose disco_tpu_torch to time")
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import disco_tpu_torch
    from disco_tpu_torch.enhance.fused import streaming_clip_fused
    from disco_tpu_torch.enhance.streaming import streaming_tango
    from disco_tpu_torch.ops import _build, cov_ops, eigh_ops, mwf_ops, stft_ops

    assert Path(disco_tpu_torch.__file__).resolve().is_relative_to(root), disco_tpu_torch.__file__
    if not torch.cuda.is_available():
        print("custom_op_host_cost: needs a CUDA device", file=sys.stderr)
        return 1
    _build.load()
    rng = np.random.default_rng(0)
    dev = "cuda"
    y = torch.as_tensor(rng.standard_normal((K, C, LW)), dtype=torch.float32, device=dev)
    mz = torch.as_tensor(rng.uniform(0.1, 0.9, (K, 257, 1 + LW // 256)), dtype=torch.float32,
                         device=dev)

    def window(state):
        return streaming_clip_fused(y, masks_z=mz, update_every=U, blocks_per_dispatch=16,
                                    solver="jacobi-pallas", state=state)

    def timed_window(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = window(state)["state"]
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) * 1e3

    # a tree whose kernels are ops: each window alternates with one whose
    # STFT and eigensolver wrappers launch past the dispatcher (the same
    # launches, no op)
    has_ops = hasattr(eigh_ops, "_eigh_op")
    direct = {} if not has_ops else {
        (stft_ops, "_stft_op"): lambda x, n, h, m: stft_ops._stft_launch(x, n, h, m, False),
        (eigh_ops, "_eigh_op"): eigh_ops._eigh_launch}
    state = window(None)["state"]
    lat, lat_direct = [], []
    for _ in range(RUNS):
        state, ms = timed_window(state)
        lat.append(ms)
        if has_ops:
            saved = {key: getattr(*key) for key in direct}
            for (mod, name), fn in direct.items():
                setattr(mod, name, fn)
            try:
                state, ms = timed_window(state)
            finally:
                for (mod, name), fn in saved.items():
                    setattr(mod, name, fn)
            lat_direct.append(ms)

    Y = torch.complex(*(torch.as_tensor(rng.standard_normal((K, C, 257, BLOCK)),
                                        dtype=torch.float32, device=dev) for _ in range(2)))
    mb = torch.as_tensor(rng.uniform(0.1, 0.9, (K, 257, BLOCK)), dtype=torch.float32, device=dev)
    s_state = streaming_tango(Y, mb, mb, update_every=U, solver="jacobi-pallas")["state"]
    dispatch, block = [], []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_state = streaming_tango(Y, mb, mb, update_every=U, solver="jacobi-pallas",
                                  state=s_state)["state"]
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        dispatch.append((t1 - t0) * 1e3)
        block.append((time.perf_counter() - t0) * 1e3)

    # the host time of one wrapper call at a small shape, each kernel
    A = torch.eye(4, dtype=torch.complex64, device=dev).expand(16, 4, 4).contiguous()
    x = torch.zeros((2, 1024), dtype=torch.float32, device=dev)
    yc = torch.zeros((2, 4, 5, 8), dtype=torch.complex64, device=dev)
    mc = torch.full((2, 5, 8), 0.5, dtype=torch.float32, device=dev)
    calls = {"stft": lambda: stft_ops.stft_kernel(x, with_mag=True),
             "masked_cov": lambda: cov_ops.masked_cov_kernel(yc, mc),
             "fused_mwf": lambda: mwf_ops.fused_mwf_kernel(A, A, mu=1.0),
             "eigh_jacobi": lambda: eigh_ops.eigh_jacobi_kernel(A)}
    host_us = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        n = 2000
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        host_us[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()

    print(json.dumps({
        "label": args.label or str(root), "torch": torch.__version__,
        "card": torch.cuda.get_device_name(0),
        "window_ms": statistics.median(lat), "window_runs_ms": lat,
        "window_direct_ms": statistics.median(lat_direct) if lat_direct else None,
        "window_direct_runs_ms": lat_direct,
        "serve_dispatch_ms": statistics.median(dispatch), "serve_block_ms": statistics.median(block),
        "serve_dispatch_runs_ms": dispatch,
        "call_host_us": host_us,
        "custom_op": hasattr(torch.ops, "disco_torch") and hasattr(torch.ops.disco_torch,
                                                                   "eigh_jacobi"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
