"""``disco-scenes`` — the batched scenario factory CLI (the port's; the
counterpart of ``disco_tpu/cli/scenes.py``).

Subcommands:

* ``simulate`` — draw + simulate N scene batches and report throughput,
  with the batched-readback and signature accounting printed so the
  one-readback-per-batch property is inspectable by hand.
* ``stream`` — pull training batches from a :class:`~disco_tpu_torch.
  scenes.stream.SceneStream` and report window counts/shapes (the dry-run
  of the flywheel feed; ``--ledger`` exercises the scene-batch resume
  units).
* ``dynamic`` — simulate one moving-source scene and report the boundary
  continuity statistics the scene-check gate bounds.

Each runs on ``--device`` (the ISM, convolutions and STFT kernel on the
card).  No reference counterpart: the reference has no scenario-factory
tooling (SURVEY.md §0).
"""
from __future__ import annotations

import argparse
import json
import time

from disco_tpu_torch.cli.common import add_device_arg
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-scenes`` argument parser."""
    p = argparse.ArgumentParser(description="Batched on-device scenario factory")
    sub = p.add_subparsers(dest="cmd", required=True)

    sim = sub.add_parser("simulate", help="simulate scene batches, report throughput")
    sim.add_argument("--batches", type=int, default=2, help="scene batches to simulate")
    sim.add_argument("--scenes", "-B", type=int, default=8, help="scenes per batch")
    sim.add_argument("--duration", type=float, default=1.0, help="dry seconds per scene")
    sim.add_argument("--scenario", default="random",
                     choices=["random", "meeting", "living", "meetit"])
    sim.add_argument("--max_order", type=int, default=8, help="ISM reflection order")
    sim.add_argument("--seed", type=int, default=0)
    add_device_arg(sim)

    st = sub.add_parser("stream", help="dry-run the SceneStream training feed")
    st.add_argument("--batches", type=int, default=2, help="scene batches per epoch")
    st.add_argument("--scenes", "-B", type=int, default=4, help="scenes per batch")
    st.add_argument("--batch_size", type=int, default=8, help="training batch size")
    st.add_argument("--duration", type=float, default=0.5, help="dry seconds per scene")
    st.add_argument("--win_len", type=int, default=8, help="window length in frames")
    st.add_argument("--max_order", type=int, default=4, help="ISM reflection order")
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--ledger", default=None,
                    help="RunLedger path (arms per-scene-batch verified "
                         "resume: ledger-done batches are skipped)")
    add_device_arg(st)

    dyn = sub.add_parser("dynamic", help="simulate one moving-source scene")
    dyn.add_argument("--segments", type=int, default=6, help="stationary segments")
    dyn.add_argument("--crossfade", type=int, default=512,
                     help="boundary crossfade in samples (0 = hard switch)")
    dyn.add_argument("--duration", type=float, default=1.0, help="dry seconds")
    dyn.add_argument("--max_order", type=int, default=6)
    dyn.add_argument("--seed", type=int, default=0)
    add_device_arg(dyn)
    return p


def _cmd_simulate(args, device) -> dict:
    import numpy as np

    from disco_tpu_torch.obs import accounting
    from disco_tpu_torch.scenes.batched import draw_scene_batch, simulate_scene_batch

    rng = np.random.default_rng(args.seed)
    g0, f0 = accounting.device_get_count(), accounting.fence_count()
    t0 = time.perf_counter()
    n_scenes = 0
    for _ in range(args.batches):
        batch = draw_scene_batch(rng, args.scenes, scenario=args.scenario,
                                 duration_s=args.duration)
        simulate_scene_batch(batch, max_order=args.max_order, device=device)
        n_scenes += batch.n_scenes
    dt = time.perf_counter() - t0
    return {
        "cmd": "simulate",
        "n_batches": args.batches,
        "n_scenes": n_scenes,
        "scenes_per_s": n_scenes / dt if dt > 0 else None,
        "elapsed_s": dt,
        "device_get_batches": accounting.device_get_count() - g0,
        "fences": accounting.fence_count() - f0,
        "recompiles_scene_batch": accounting.recompile_count("scene_batch"),
    }


def _cmd_stream(args, device) -> dict:
    from disco_tpu_torch.scenes.stream import SceneStream

    stream = SceneStream(seed=args.seed, scenes_per_batch=args.scenes,
                         batches_per_epoch=args.batches,
                         duration_s=args.duration, max_order=args.max_order,
                         win_len=args.win_len, device=device)
    n, shape = 0, None
    t0 = time.perf_counter()
    for x, y in stream.batches(args.batch_size, epoch=0, ledger=args.ledger):
        n += 1
        shape = (list(x.shape), list(y.shape))
    dt = time.perf_counter() - t0
    return {
        "cmd": "stream",
        "n_batches": n,
        "batch_shape": shape,
        "elapsed_s": dt,
        "geometry": stream.peek_geometry(),
    }


def _cmd_dynamic(args, device) -> dict:
    import numpy as np

    from disco_tpu_torch.scenes.dynamic import (
        boundary_jumps,
        dynamic_scene_mixture,
        piecewise_trajectory,
    )

    fs = 16000
    L = int(args.duration * fs)
    t = np.arange(L) / fs
    dry = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    path = piecewise_trajectory([1.0, 1.0, 1.5], [3.0, 2.0, 1.5], args.segments)
    mics = np.asarray([[2.0, 1.5, 1.0], [2.2, 1.5, 1.0]], np.float32)
    out = dynamic_scene_mixture([4.0, 3.0, 2.5], path, mics, 0.3, dry,
                                crossfade=args.crossfade,
                                max_order=args.max_order, rir_len=2048, device=device)
    jumps = boundary_jumps(out["mixture"], args.segments)
    return {
        "cmd": "dynamic",
        "n_segments": args.segments,
        "crossfade": args.crossfade,
        "mixture_shape": list(out["mixture"].shape),
        "boundary_jump_max": float(jumps.max()) if jumps.size else 0.0,
        "mixture_rms": float(np.sqrt(np.mean(np.square(out["mixture"])))),
    }


def main(argv=None):
    """``disco-scenes`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.cmd == "simulate":
        out = _cmd_simulate(args, device)
    elif args.cmd == "stream":
        out = _cmd_stream(args, device)
    else:
        out = _cmd_dynamic(args, device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
