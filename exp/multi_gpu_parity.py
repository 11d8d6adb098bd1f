"""The port's multi-GPU paths across four cards, held against their 1-rank
runs: run under torchrun over NCCL, one rank a card::

    torchrun --nproc_per_node 4 exp/multi_gpu_parity.py [--out multi_gpu.json]

Every rank makes the north-star clip (K=8 nodes x C=4 mics, 10 s at
16 kHz, seed 0) and its STFT on its own card, then:

1. ``tango_sharded`` on a (batch 1, node 4) mesh — two nodes a card, the
   z-exchange one ``all_gather`` over NVLink and, again, the ring — with
   ``solver='fused'``; the gathered result is held against the 1-rank
   ``tango`` of the whole clip on the same card (1e-5 relative L2, the JAX
   package's bound; the ring bit for bit the ``all_gather``);
2. ``tango_frame_sharded`` on a (node 2, frame 2) mesh against the same
   ``tango`` (1e-4 of the output scale);
3. three data-parallel train steps of the canonical CRNN (``n_ch`` 1) on a
   (batch 4, node 1) mesh at a global batch of 256 windows against the
   meshless steps (``flywheel.check.MESH_LOSS_RTOL``).

Times are CUDA events on rank 0 (median of 5 after 2 warm-ups): the
sharded call beside the 1-rank call on one card.  Rank 0 prints one JSON
line (and writes it to ``--out``) with the card's name and power limit;
the exit code is 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

K, C, FS, DUR_S, SEED = 8, 4, 16000, 10.0, 0
DP_BATCH, DP_STEPS = 256, 3
FIELDS = ("yf", "sf", "nf", "z_y", "z_s", "z_n", "zn")


def scene(device):
    """(y, s, n), each (K, C, L) float32 on ``device``: a broadband source
    through short random filters per mic plus white noise."""
    rng = np.random.default_rng(SEED)
    L = int(DUR_S * FS)
    src = rng.standard_normal(L)
    s = np.stack([np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same")
                            for _ in range(C)]) for _ in range(K)]).astype(np.float32)
    n = 0.5 * rng.standard_normal((K, C, L)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (s + n, s, n))


def events_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()

    from disco_tpu_torch.core.dsp import stft
    from disco_tpu_torch.enhance.tango import oracle_masks, tango
    from disco_tpu_torch.flywheel.check import MESH_LOSS_RTOL
    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, make_step_fns, replicate_to_mesh
    from disco_tpu_torch.ops import _build
    from disco_tpu_torch.parallel import (
        distributed_init,
        gather_result,
        make_mesh,
        make_mesh_2d,
        shard_of,
        tango_frame_sharded,
        tango_sharded,
    )

    if not distributed_init():
        print("multi_gpu_parity: run under torchrun --nproc_per_node 4", file=sys.stderr)
        return 1
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    if rank == 0:
        _build.load()  # one build; the other ranks load it
    dist.barrier()
    _build.load()
    y, s, n = scene(dev)
    Y, S, N = stft(y), stft(s), stft(n)
    m = oracle_masks(S, N, "irm1")
    report, checks = {"world": world}, {}

    # 1. node-sharded, two nodes a card
    mesh = make_mesh(n_node=world, device="cuda")
    sh = [shard_of(a, mesh) for a in (Y, S, N, m)]
    one = tango(Y, S, N, m, m, solver="fused", device=dev)

    def node_run(exchange="all_gather"):
        return tango_sharded(*sh, sh[3], mesh, solver="fused", z_exchange=exchange)

    full = gather_result(node_run(), mesh)
    ring = gather_result(node_run("ring"), mesh)
    err = max(rel_l2(getattr(full, f), getattr(one, f)) for f in FIELDS)
    checks["node"] = err <= 1e-5
    checks["ring"] = all(torch.equal(getattr(full, f), getattr(ring, f)) for f in FIELDS)
    report["node_rel_l2"] = err
    report["node_ms"] = events_ms(node_run)
    report["node_ring_ms"] = events_ms(lambda: node_run("ring"))
    report["one_rank_ms"] = events_ms(lambda: tango(Y, S, N, m, m, solver="fused", device=dev))

    # 2. frame-sharded on (node 2, frame 2)
    mesh2 = make_mesh_2d(world // 2, 2, device="cuda")
    T = Y.shape[-1] // 2 * 2
    spec4, spec3 = ("node", None, None, "frame"), ("node", None, "frame")
    fs = [shard_of(a[..., :T], mesh2, spec4) for a in (Y, S, N)]
    fm = shard_of(m[..., :T], mesh2, spec3)
    one_t = tango(Y[..., :T], S[..., :T], N[..., :T], m[..., :T], m[..., :T], solver="fused",
                  device=dev)

    def frame_run():
        return tango_frame_sharded(*fs, fm, fm, mesh2, solver="fused")

    ferr = max(max_rel(getattr(gather_result(frame_run(), mesh2), f), getattr(one_t, f))
               for f in FIELDS)
    checks["frame"] = ferr <= 1e-4
    report["frame_max_rel"] = ferr
    report["frame_ms"] = events_ms(frame_run)

    # 3. data-parallel steps of the canonical CRNN
    rng = np.random.default_rng(SEED)
    batches = [(rng.random((DP_BATCH, 1, 21, 257), np.float32) + 0.05,
                rng.random((DP_BATCH, 21, 257), np.float32)) for _ in range(DP_STEPS)]
    dp_mesh = make_mesh(n_node=1, n_batch=world, device="cuda")
    losses = {}
    for lane, msh in (("meshless", None), ("mesh", dp_mesh)):
        torch.manual_seed(SEED)
        model = build_crnn(n_ch=1).to(dev)
        state = create_train_state(model, build_optimizer(model), seed=SEED)
        if msh is not None:
            state = replicate_to_mesh(state, msh)
        step, _ = make_step_fns(model, "all", mesh=msh)
        losses[lane] = np.asarray([float(step(state, x, t)[1]) for x, t in batches])
        report[f"dp_step_ms_{lane}"] = events_ms(lambda: step(state, *batches[0]), reps=3)
    rel = float(np.max(np.abs(losses["mesh"] - losses["meshless"]) / np.abs(losses["meshless"])))
    checks["data_parallel"] = rel <= MESH_LOSS_RTOL
    report["dp_loss_rel"] = rel

    verdicts = [None] * world
    dist.all_gather_object(verdicts, checks)
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        report["cards"] = sorted(set(smi.stdout.strip().splitlines()))
        report["checks"] = verdicts
        line = json.dumps(report)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(line + "\n")
    ok = all(all(v.values()) for v in verdicts)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
