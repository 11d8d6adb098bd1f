"""The flywheel's legs, as functions of a device (the port's counterpart of
``disco_tpu/flywheel/check.py``).

1. :func:`check_tap_serve` — loopback serve traffic with the corpus tap
   on: every delivered block spooled with no drop, one batched readback a
   tick, every rotated shard passing its probe and the manifest's verified
   replay (``serve.check.check_tap``), and at least two shards.
2. :func:`check_torn_shard` — a ``mid_write`` crash inside a shard write
   leaves no shard at its final path and no temp litter; a planted
   truncated shard fails ``probe_shard`` and is skipped by the dataset
   (``shards_skipped``), never fed to training.
3. :func:`check_dataset_resume` — the dataset's batch stream is the same
   for one (seed, epoch), and a ledger-armed epoch replays to no batch once
   complete.
4. :func:`check_fit` — ``nn.training.fit`` trains from
   ``ShardDataset.batch_fn`` with a ledger and writes a checkpoint whose
   ``epochs_done`` restores.
5. :func:`check_data_parallel` — the data-parallel ``train_step`` (a
   ``batch`` mesh over ``torch.distributed`` ranks, replicated state) is bit
   for bit the meshless oracle at one rank, in losses and parameters, and
   within :data:`MESH_LOSS_RTOL` of it at N ranks; a short ``fit`` on the
   mesh writes a checkpoint whose ``epochs_done`` restores.

:func:`main` runs the five legs as a command (``python -m
disco_tpu_torch.flywheel.check``, on ``cuda`` unless given ``--device
cpu``) and reads its event log back, as the JAX gate does.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

#: the tolerance of the N-rank data-parallel losses against the meshless
#: oracle (the JAX gate's): each rank's share of the batch-mean loss, the
#: BatchNorm statistics and the gradients are summed over the ranks, which
#: reorders the sums; one rank reorders nothing and must be bit for bit
MESH_LOSS_RTOL = 2e-4
#: steps of the data-parallel leg, and its batch (divisible by 2, 4 and 8
#: ranks)
TRAIN_STEPS, TRAIN_BATCH = 6, 8


def check_tap_serve(failures: list, tap_dir, specs: list, *, device=None) -> dict:
    """Leg 1: ``specs`` are :func:`~disco_tpu_torch.serve.check.check_parity`
    sessions (STFT domain), served with a tap rotating every 3 blocks."""
    from disco_tpu_torch.serve.check import check_tap

    stats = check_tap(failures, specs, tap_dir, device=device, records_per_shard=3,
                      label="tap-serve")
    if stats["shards"] < 2:
        failures.append(f"tap-serve: expected >= 2 rotated shards, got {stats['shards']}")
    return stats


def check_torn_shard(failures: list, tap_dir, *, win_len: int, batch_size: int) -> dict:
    """Leg 2 over a tap directory holding shards."""
    from disco_tpu_torch.flywheel import ShardDataset, list_shards, probe_shard, read_shard, write_shard
    from disco_tpu_torch.io.atomic import TMP_SUFFIX
    from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
    from disco_tpu_torch.runs import chaos

    tap_dir = Path(tap_dir)
    before = list_shards(tap_dir)
    if not before:
        failures.append("torn-shard: no shards on disk to crash against")
        return {"batches_with_torn_present": 0, "skipped": 0}
    victim = tap_dir / "tap-900000.shard.msgpack"
    _meta, records = read_shard(before[0])
    chaos.configure("mid_write", after=1)
    try:
        write_shard(victim, records)
        failures.append("torn-shard: the mid_write crash never fired in write_shard")
    except chaos.ChaosCrash:
        pass
    finally:
        chaos.disable()
    if victim.exists():
        failures.append("torn-shard: a shard reached its final path through a mid-write crash")
    litter = [str(p) for p in tap_dir.rglob(f"*{TMP_SUFFIX}.*")]
    if litter:
        failures.append(f"torn-shard: temp litter left on unwind: {litter}")
    if list_shards(tap_dir) != before:
        failures.append("torn-shard: the shard listing changed across the crash")
    write_shard(victim, records)   # the same write lands once the 'process' is back
    if not probe_shard(victim):
        failures.append("torn-shard: the rewrite after the crash fails its probe")
    # a torn shard at a final path (damage behind the writer's back) is
    # skipped loudly, never trained on
    torn = tap_dir / "tap-900001.shard.msgpack"
    raw = victim.read_bytes()
    torn.write_bytes(raw[: len(raw) // 2])  # disco-torch-lint: disable=DL004 -- deliberately planting a torn artifact; the gate asserts the reader rejects it
    if probe_shard(torn):
        failures.append("torn-shard: a truncated shard passes probe_shard")
    ds = ShardDataset(tap_dir, win_len=win_len, seed=0)
    skipped0 = obs_registry.peek_counter("shards_skipped")
    n_batches = sum(1 for _ in ds.batches(batch_size, epoch=0))
    skipped = obs_registry.peek_counter("shards_skipped") - skipped0
    if skipped != 1:
        failures.append(f"torn-shard: the dataset skipped {skipped} shards, expected the "
                        "planted torn one")
    if n_batches == 0:
        failures.append("torn-shard: the dataset yielded nothing with intact shards present")
    torn.unlink()
    victim.unlink()
    if list_shards(tap_dir) != before:
        failures.append("torn-shard: residue left in the tap dir")
    return {"batches_with_torn_present": n_batches, "skipped": skipped}


def check_dataset_resume(failures: list, tap_dir, scratch, *, win_len: int,
                         batch_size: int) -> dict:
    """Leg 3: a deterministic stream, and a ledger-verified epoch resume."""
    from disco_tpu_torch.flywheel import ShardDataset

    ds = ShardDataset(tap_dir, win_len=win_len, seed=11)
    a = list(ds.batches(batch_size, epoch=0))
    b = list(ds.batches(batch_size, epoch=0))
    if not a:
        failures.append("resume: the dataset yields no batches")
    if len(a) != len(b) or not all(np.array_equal(xa, xb) and np.array_equal(ya, yb)
                                   for (xa, ya), (xb, yb) in zip(a, b)):
        failures.append("resume: the (seed, epoch) batch stream is not deterministic")
    led = Path(scratch) / "dataset_ledger.jsonl"
    first = list(ds.batches(batch_size, epoch=0, ledger=led))
    again = list(ds.batches(batch_size, epoch=0, ledger=led))
    if len(first) != len(a):
        failures.append("resume: the ledger-armed epoch differs from the bare one")
    if again:
        failures.append(f"resume: a completed epoch replayed {len(again)} batches")
    return {"batches_per_epoch": len(a)}


def check_fit(failures: list, tap_dir, scratch, arch: dict, *, win_len: int,
              batch_size: int, device=None) -> dict:
    """Leg 4: ``fit`` over ``ShardDataset.batch_fn`` (shuffled, with a
    ledger) and the natural-order validation stream, on ``device``; the
    best checkpoint restores its ``epochs_done``."""
    import torch

    from disco_tpu_torch.device import resolve_device
    from disco_tpu_torch.flywheel import ShardDataset
    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, fit, load_checkpoint

    dev = resolve_device(device)
    scratch = Path(scratch)
    ds = ShardDataset(tap_dir, win_len=win_len, seed=3)
    kw = {k: v for k, v in arch.items() if k not in ("learning_rate", "clip_grad_norm")}

    def fresh():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5)
            model = build_crnn(**kw).to(dev)
        return model, create_train_state(model, build_optimizer(model), seed=5)

    model, state = fresh()
    n_epochs = 2
    state, tr, _va, run_name = fit(
        model, state,
        ds.batch_fn(batch_size, shuffle=True, ledger=scratch / "fit_ledger.jsonl"),
        ds.batch_fn(batch_size, shuffle=False),
        n_epochs=n_epochs, save_path=scratch / "models", verbose=False, device=dev)
    ckpt = scratch / "models" / f"{run_name}_model.msgpack"
    n_restored = 0
    if not ckpt.exists():
        failures.append("fit: no checkpoint was saved")
    else:
        _model, state2 = fresh()
        _, tr_hist, _ = load_checkpoint(ckpt, state2)
        n_restored = len(tr_hist)
        if not 1 <= n_restored <= n_epochs:
            failures.append(f"fit: the checkpoint restored {n_restored} epochs, expected "
                            f"1..{n_epochs}")
    if not np.all(np.isfinite(tr)) or np.count_nonzero(tr) != n_epochs:
        failures.append(f"fit: train losses {tr.tolist()} are not {n_epochs} finite epochs")
    return {"fit_epochs": int(np.count_nonzero(tr)), "train_loss": float(tr[-1]),
            "epochs_restored": n_restored}


# -- leg 5: data parallelism ------------------------------------------------
def _dp_model(arch: dict, dev):
    """The leg's seeded model and training state on ``dev``."""
    import torch

    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state

    kw = {k: v for k, v in arch.items() if k not in ("learning_rate", "clip_grad_norm")}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = build_crnn(**kw).to(dev)
    return model, create_train_state(model, build_optimizer(model), seed=5)


def _dp_steps(arch: dict, batches: list, dev, mesh=None):
    """The leg's steps from the seeded state: (losses, first parameter,
    model)."""
    from disco_tpu_torch.nn.training import make_step_fns, replicate_to_mesh

    model, state = _dp_model(arch, dev)
    if mesh is not None:
        state = replicate_to_mesh(state, mesh)
    step, _ = make_step_fns(model, "all", mesh=mesh)
    losses = [step(state, x, y)[1] for x, y in batches]
    return (np.asarray([float(v) for v in losses]),
            next(model.parameters()).detach().cpu().numpy(), model)


def _dp_fit(arch: dict, tap_dir, save_dir, *, win_len: int, batch_size: int, dev, mesh):
    """A 2-epoch ``fit`` on ``mesh``; the epochs its checkpoint restores
    (every rank reads rank 0's file)."""
    import torch.distributed as dist

    from disco_tpu_torch.flywheel import ShardDataset
    from disco_tpu_torch.nn.training import fit, load_checkpoint

    model, state = _dp_model(arch, dev)
    ds = ShardDataset(tap_dir, win_len=win_len, seed=3)
    state, tr, _va, run_name = fit(
        model, state, ds.batch_fn(batch_size, shuffle=True), ds.batch_fn(batch_size),
        n_epochs=2, save_path=save_dir, run_name="dp", verbose=False, device=dev, mesh=mesh)
    dist.barrier()
    ckpt = Path(save_dir) / f"{run_name}_model.msgpack"
    if not ckpt.exists():
        return 0, tr
    _model, fresh = _dp_model(arch, dev)
    return len(load_checkpoint(ckpt, fresh)[1]), tr


def _dp_rank(rank: int, world: int, arch: dict, batches_path: str, tap_dir: str,
             out_dir: str, win_len: int, batch_size: int, device) -> None:
    """One rank of the N-rank leg: the mesh steps, then the mesh fit; rank
    0 writes what it saw."""
    import torch

    from disco_tpu_torch.io.atomic import savez_atomic
    from disco_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    raw = np.load(batches_path)
    batches = [(raw[f"x{i}"], raw[f"y{i}"]) for i in range(len(raw.files) // 2)]
    mesh = make_mesh(n_node=1, n_batch=world, device=device)
    losses, first, _ = _dp_steps(arch, batches, dev, mesh)
    restored, tr = _dp_fit(arch, tap_dir, Path(out_dir) / "models", win_len=win_len,
                           batch_size=batch_size, dev=dev, mesh=mesh)
    if rank == 0:
        savez_atomic(Path(out_dir) / "dp_ranks.npz", losses=losses, first=first,
                     restored=restored, fit_losses=tr)


def check_data_parallel(failures: list, tap_dir, scratch, arch: dict, *, win_len: int,
                        batch_size: int = TRAIN_BATCH, steps: int = TRAIN_STEPS,
                        ranks: int = 1, device=None) -> dict:
    """Leg 5 over the tapped shards on ``device``: the meshless oracle, the
    1-rank mesh (in a 1-rank world of this process) bit for bit against it,
    and, with ``ranks`` > 1, ``ranks`` spawned ranks (gloo on the CPU, one
    card a rank on ``cuda``) within :data:`MESH_LOSS_RTOL`; the mesh fit
    (at the widest world run) restores 1 or 2 epochs."""
    from disco_tpu_torch.device import resolve_device
    from disco_tpu_torch.flywheel import ShardDataset
    from disco_tpu_torch.io.atomic import savez_atomic
    from disco_tpu_torch.parallel import make_mesh, single_rank_world
    from disco_tpu_torch.parallel.multihost import spawn_world

    dev = resolve_device(device)
    scratch = Path(scratch)
    batches = list(ShardDataset(tap_dir, win_len=win_len, seed=3).batches(
        batch_size, epoch=0))[:steps]
    if len(batches) < 2:
        failures.append(f"data-parallel: only {len(batches)} batches available")
        return {}
    oracle, p_oracle, _ = _dp_steps(arch, batches, dev)
    with single_rank_world(dev.type):
        mesh1 = make_mesh(n_node=1, n_batch=1, device=dev.type)
        one, p_one, _ = _dp_steps(arch, batches, dev, mesh1)
        if ranks <= 1:
            restored, _tr = _dp_fit(arch, tap_dir, scratch / "dp_models", win_len=win_len,
                                    batch_size=batch_size, dev=dev, mesh=mesh1)
    if not np.array_equal(oracle, one):
        failures.append(f"data-parallel: 1-rank mesh losses differ from the meshless oracle "
                        f"(max abs diff {np.abs(oracle - one).max():g}); the 1-rank lane must "
                        "be bit for bit")
    if not np.array_equal(p_oracle, p_one):
        failures.append("data-parallel: 1-rank mesh params drift from the oracle")
    sharded = None
    if ranks > 1:
        path = scratch / "dp_batches.npz"
        savez_atomic(path, **{f"{k}{i}": b[j] for i, b in enumerate(batches)
                              for j, k in enumerate("xy")})
        spawn_world(_dp_rank, ranks, dev.type,
                    (arch, str(path), str(tap_dir), str(scratch), win_len, batch_size,
                     dev.type))
        got = np.load(scratch / "dp_ranks.npz")
        sharded, restored = got["losses"], int(got["restored"])
        rel = np.abs(sharded - oracle) / np.maximum(np.abs(oracle), 1e-12)
        if rel.max() > MESH_LOSS_RTOL:
            failures.append(f"data-parallel: {ranks}-rank losses off by rel {rel.max():g} > "
                            f"MESH_LOSS_RTOL={MESH_LOSS_RTOL:g}")
        if not np.all(np.isfinite(got["fit_losses"])):
            failures.append("data-parallel: the mesh fit's losses are not finite")
    if not 1 <= restored <= 2:
        failures.append(f"data-parallel: the mesh fit's checkpoint restored {restored} epochs, "
                        "expected 1..2")
    return {"ranks": ranks, "steps": len(batches), "oracle_loss": float(oracle[-1]),
            "mesh_loss": float(sharded[-1]) if sharded is not None else float(one[-1]),
            "mesh_loss_rtol": MESH_LOSS_RTOL, "epochs_restored": restored}


# -- the command ------------------------------------------------------------
def main(argv=None) -> int:
    """Run the flywheel gate (the port's ``make flywheel-check``): the five
    legs on ``--device`` (``cuda`` by default; RuntimeError without a GPU),
    then its event log read back; exit 1 on a failure, else print one JSON
    line.  The data-parallel leg spawns 2 gloo ranks on the CPU and one rank
    a card on ``cuda``; fewer than 2 cards fail the gate, as fewer than 2
    devices fail the JAX gate."""
    import argparse

    import torch

    from disco_tpu_torch import obs
    from disco_tpu_torch.device import resolve_device
    from disco_tpu_torch.promote.check import tiny_arch
    from disco_tpu_torch.serve import check as sc

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.flywheel.check",
                                 description="the serve -> train flywheel gate")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ranks = 2 if dev.type == "cpu" else torch.cuda.device_count()
    K, C = 4, 2
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        obs_log = tmp / "flywheel_check.jsonl"
        with obs.recording(obs_log):
            obs.write_manifest(tool="flywheel-check")
            specs = []
            for i in range(2):
                Y, m = sc.scene(61 + i, length=16000, n_nodes=K, n_mics=C, device=dev)
                cfg = sc.session_config(Y.shape[-2], n_nodes=K, n_mics=C)
                specs.append({"Y": Y, "m": m, "config": cfg,
                              "ref": sc.offline_stream(Y, m, device=dev)})
            win = cfg.block_frames // 2
            arch = tiny_arch(Y.shape[-2], win)
            tap_dir = tmp / "tap"
            served = check_tap_serve(failures, tap_dir, specs, device=dev)
            check_torn_shard(failures, tap_dir, win_len=win, batch_size=TRAIN_BATCH)
            resume = check_dataset_resume(failures, tap_dir, tmp, win_len=win,
                                          batch_size=TRAIN_BATCH)
            check_fit(failures, tap_dir, tmp, arch, win_len=win, batch_size=TRAIN_BATCH,
                      device=dev)
            training = check_data_parallel(failures, tap_dir, tmp, arch, win_len=win,
                                           ranks=ranks, device=dev)
            if ranks < 2:
                failures.append(f"data-parallel: only {ranks} device(s) — run on a host "
                                "with 2 or more cards, or with --device cpu (2 gloo ranks)")
            obs.record("counters", **obs.REGISTRY.snapshot())
        events = obs.read_events(obs_log)
        failures.extend(event_log_failures(events))
    if failures:
        for f in failures:
            print(f"flywheel-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({
        "flywheel_check": "ok",
        "served_blocks": served.get("blocks_accepted"),
        "shards": served.get("shards"),
        "batches_per_epoch": resume["batches_per_epoch"],
        "ranks": training.get("ranks"),
        "train_steps": training.get("steps"),
        "oracle_loss": training.get("oracle_loss"),
        "mesh_loss": training.get("mesh_loss"),
        "mesh_loss_rtol": training.get("mesh_loss_rtol"),
        "device": dev.type,
    }))
    return 0


def event_log_failures(events: list) -> list:
    """The JAX gate's event-log checks (``disco_tpu/flywheel/check.py:
    397-403``), letter for letter."""
    failures = []
    if not any(e["kind"] == "tap" and e["attrs"].get("action") == "shard" for e in events):
        failures.append("event log missing tap shard-rotation events")
    if not any(e["kind"] == "warning" and "corrupt shard" in str(e["attrs"].get("reason", ""))
               for e in events):
        failures.append("event log missing the corrupt-shard warning")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
