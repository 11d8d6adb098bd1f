#!/usr/bin/env python3
"""The image-source RIR engine and one scene batch on the card.

Checks what the batched generator's byte-identical resume rests on, then
times the engine at SceneStream's default batch:

1. the order-20 RIRs of ``tests/data/golden_rir_order20.npz``'s room (2
   sources x 4 mics) against the float64 fixture and against the host's
   run (relative L2 a RIR), and two card runs against each other;
2. 40 RIR rows computed in chunks of one row and in one chunk, bit for
   bit;
3. the kernels one accumulating scatter launches (``torch.profiler``): a
   radix sort and the ordered reduction of each run of equal indices;
4. three ``SceneStream`` scene batches (8 scenes x 2 sources x 16 mics,
   order 20, 1 s; the first builds the STFT kernel), host clock to a
   synchronize, and the STFT launches each;
5. ``shoebox_rirs_batched`` on one drawn batch, CUDA events, three times,
   and its kernels under the profiler; the peak of allocated memory.

    PYTHONPATH=. python3 exp/ism_probe.py
"""
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from disco_tpu_torch.ops import stft_ops
from disco_tpu_torch.scenes import SceneStream
from disco_tpu_torch.scenes.batched import draw_scene_batch
from disco_tpu_torch.sim import ism


def rel(x, y) -> float:
    return float((np.linalg.norm(x - y, axis=-1) / np.linalg.norm(y, axis=-1)).max())


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(torch.__version__, torch.version.cuda, flush=True)
    g = np.load("tests/data/golden_rir_order20.npz")
    args = (g["room_dim"].astype(np.float32), g["sources"].astype(np.float32),
            g["mics"].astype(np.float32), float(g["alpha"]))
    kw = dict(max_order=int(g["max_order"]), rir_len=int(g["rir_len"]))
    a, b = ism.shoebox_rirs(*args, **kw), ism.shoebox_rirs(*args, **kw)
    host = ism.shoebox_rirs(*args, **kw, device="cpu")
    print("golden", rel(a.cpu().numpy().astype(np.float64), g["rirs"]), "card-vs-host",
          rel(a.cpu().numpy(), host.numpy()), "twice equal", torch.equal(a, b), flush=True)

    rows = [torch.as_tensor(x, dtype=torch.float32, device="cuda") for x in (
        np.repeat(args[0][None], 40, 0), args[1][[0, 1] * 20], args[2][[0, 1, 2, 3] * 10],
        np.full(40, args[3]))]
    whole = ism._rir_rows(*rows, 20, 12288, 16000)
    print("chunks equal", torch.equal(whole, ism._rir_rows(*rows, 20, 12288, 16000, budget=1)),
          torch.equal(whole, ism._rir_rows(*rows, 20, 12288, 16000, budget=1 << 40)), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ism.shoebox_rirs(*args, max_order=4, rir_len=4096)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)

    stream = SceneStream(seed=0)
    for i in range(3):
        stft_ops.stft_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stream.simulate_batch(0, i % 2)
        torch.cuda.synchronize()
        print("scene batch", i, {k: v.shape for k, v in out.items()}, "s",
              time.perf_counter() - t0, "launches", stft_ops.stft_kernel.launches, flush=True)

    batch = draw_scene_batch(np.random.default_rng(0), 8)
    dims, srcs, mics, alphas = (torch.as_tensor(x, device="cuda") for x in (
        batch.room_dims, batch.sources, batch.mics, batch.alphas))
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ism.shoebox_rirs_batched(dims, srcs, mics, alphas, 20, 14336)
        end.record()
        torch.cuda.synchronize()
        print("ism 8x2x16 order 20 ms", start.elapsed_time(end), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ism.shoebox_rirs_batched(dims, srcs, mics, alphas, 20, 14336)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20), flush=True)
    print("peak GB", torch.cuda.max_memory_allocated() / 1e9)


if __name__ == "__main__":
    main()
