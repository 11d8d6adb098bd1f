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

Left out: the JAX gate's data-parallel leg (mesh training with loss parity
against the single-device oracle) comes with multi-GPU, ROADMAP Queue 1,
item 5.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


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
    torn.write_bytes(raw[: len(raw) // 2])
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
