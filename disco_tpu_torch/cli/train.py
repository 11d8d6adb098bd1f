"""CRNN training CLI (the port's ``disco-train``; counterpart of
``disco_tpu/cli/train.py``).

Mirrors reference ``dnn/engine/train.py:19-158`` (flags --scene/--noise/
--zsigs/--weights/--files_to_load/--zfile/--n_files/--n_epochs/--path_data,
hard-coded hyperparameters train.py:66-85), on the port's training stack
(``nn.training.fit``: the step on ``--device``, SaveAndStop
best-checkpoint gating, early stop and resume; checkpoints are the JAX
package's msgpack files).

``--data-parallel N`` trains on a ``(batch N, node 1)`` mesh of
``torch.distributed`` ranks (``disco_tpu_torch.parallel``; the
data-parallel lane of ``fit``): N = 1 is one rank in this process, as the
JAX CLI's 1-device mesh; N > 1 ranks are launched by ``torchrun
--nproc_per_node N``, which ``distributed_init`` picks up, and rank 0
writes the checkpoints.  0 (the default) trains without a mesh."""
from __future__ import annotations

import argparse

import numpy as np

from disco_tpu_torch.cli.common import (
    add_device_arg,
    add_ledger_arg,
    add_obs_log_arg,
    add_preflight_arg,
    add_trace_dir_arg,
    none_str,
    obs_session,
    run_preflight,
)
from disco_tpu_torch.config import TrainConfig
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-train`` argument parser."""
    p = argparse.ArgumentParser(description="Train the mask-estimation CRNN")
    p.add_argument("--archi", choices=["crnn", "rnn"], default="crnn",
                   help="mask estimator: CRNN (3-D windows) or 2-D RNN (freq-stacked)")
    p.add_argument("--scene", default="living")
    p.add_argument("--noise", choices=["ssn", "it", "fs", "noit", "all"], default="ssn")
    p.add_argument("--zsigs", "-zs", nargs="+", default=["zs_hat"])
    p.add_argument("--weights", "-w", default="None", help="resume checkpoint path")
    p.add_argument("--files_to_load", "-f2l", default="None", help="folder of persisted input lists")
    p.add_argument("--zfile", "-zf", default="oracle", help="z export name under stft_z/")
    p.add_argument("--n_files", "-n", type=int, default=11001, help="number of training sequences")
    p.add_argument("--n_epochs", "-epo", type=int, default=150)
    p.add_argument("--path_data", "-path", default="dataset/disco/")
    p.add_argument("--save_path", default="models/")
    p.add_argument("--batch_size", type=int, default=None, help="override the canonical 500")
    p.add_argument("--single_channel", "-sc", action="store_true",
                   help="train the step-1 single-channel model (no z inputs)")
    p.add_argument("--seed", type=int, default=26, help="train.py:20 seed")
    p.add_argument("--shards", default=None, metavar="DIR",
                   help="train on a flywheel shard directory (the serve "
                        "tap's --tap-dir output, disco_tpu_torch.flywheel) "
                        "instead of the pre-generated corpus: streaming "
                        "reader with deterministic seeded shuffle, ledger "
                        "resume (--ledger) and corrupt-shard "
                        "skip-with-warning; the model is sized from the "
                        "shards' geometry")
    p.add_argument("--shard-win-len", type=int, default=None,
                   help="frames per training window on the --shards path "
                        "(default: the tapped block length; must fit "
                        "inside one block)")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="shard the batch axis over an N-rank mesh "
                        "(torch.distributed; launch N > 1 ranks with torchrun): "
                        "state replicated, each rank steps on its slice of the "
                        "batch; 0 = no mesh.  1 is the one-rank mesh")
    p.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                   help="training compute lane: 'bf16' arms mixed precision — "
                        "bf16 apply-time params and activations, float32 "
                        "master params, optimizer accumulators and loss")
    p.add_argument("--promote-dir", default=None, metavar="DIR",
                   help="publish every improved-best checkpoint as a "
                        "digest-addressed weight generation under DIR "
                        "(disco_tpu_torch.promote), where a live disco-serve "
                        "--promote-dir server canaries and promotes it; "
                        "mid-epoch checkpoints of an interrupted run are "
                        "refused by the ledger check, never staged "
                        "(CRNN only)")
    add_ledger_arg(p, "epoch")
    add_preflight_arg(p, what="the multi-hour run")
    add_obs_log_arg(p, what="training")
    add_trace_dir_arg(p)
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-train`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.data_parallel:
        check_data_parallel(args, device)
    with obs_session(args, tool="disco-train"):
        preflight = run_preflight(args)
        from disco_tpu_torch import obs as _obs

        _obs.record("run_start", stage="train", tool="disco-train",
                    preflight=preflight, ledger=args.ledger,
                    resume=none_str(args.weights) is not None)
        from disco_tpu_torch.nn.training import CheckpointError
        from disco_tpu_torch.runs import GracefulInterrupt

        try:
            with GracefulInterrupt() as stopped:
                out = _run(args, device)
            if stopped():
                print("interrupted — training wound down between epochs; resume "
                      "with --weights on the saved checkpoint")
            return out
        except CheckpointError as e:
            # a corrupt/truncated --weights checkpoint is a clean CLI error
            # naming the path, never a raw msgpack traceback
            raise SystemExit(f"--weights: {e}")


def check_data_parallel(args, device) -> None:
    """``--data-parallel N``: join the ranks' world when torchrun started
    this process, then refuse a world that is not N ranks or a batch that
    does not divide over them (the messages of ``disco-torch-tango
    --mesh``)."""
    from disco_tpu_torch.parallel import distributed_init
    from disco_tpu_torch.parallel.multihost import world_size

    distributed_init(device=device.type)
    n, n_dev = args.data_parallel, world_size()
    if n > n_dev:
        raise SystemExit(f"--data-parallel {n} needs {n} devices; {n_dev} available")
    if n < n_dev:
        raise SystemExit(f"--data-parallel {n} names {n} ranks; the torch.distributed world "
                         f"has {n_dev}")
    batch = args.batch_size or TrainConfig().batch_size
    if batch % n:
        raise SystemExit(f"--batch_size {batch} must be divisible by the mesh batch axis ({n})")
    if n > 1 and args.shards is not None and args.ledger is not None:
        # every rank's shard stream would append to the one dataset ledger
        raise SystemExit("--ledger with --shards trains on one rank: the dataset ledger has "
                         "one writer (drop --ledger or use --data-parallel 1)")


def _mesh_lane(args, device):
    """(context, mesh) of ``--data-parallel``: the 1-rank world this
    process makes for N = 1 (a torchrun world is kept), and the
    ``(batch N, node 1)`` mesh made inside it; (null context, None) at 0."""
    import contextlib

    if not args.data_parallel:
        return contextlib.nullcontext(), lambda: None
    from disco_tpu_torch.parallel import make_mesh, single_rank_world

    return single_rank_world(device.type), lambda: make_mesh(
        n_node=1, n_batch=args.data_parallel, device=device.type)


def _build(arch: dict, seed: int, device, rnn: bool = False):
    """The module of ``arch`` on ``device`` and its optimizer.  The JAX
    package draws the initial weights from ``seed``; the port's
    constructors draw from torch's generator, seeded here."""
    import torch

    from disco_tpu_torch.nn.crnn import build_crnn, build_rnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.promote.store import _OPTIMIZER_KEYS

    kw = {k: v for k, v in arch.items() if k not in _OPTIMIZER_KEYS}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (build_rnn if rnn else build_crnn)(**kw).to(device)
    return model, build_optimizer(model, learning_rate=arch["learning_rate"])


def _run_shards(args, device):
    """The flywheel path: train the single-channel mask CRNN on tapped
    serve traffic (disco_tpu_torch.flywheel.ShardDataset).  No reference
    counterpart: the reference has no serving layer to learn from."""
    from disco_tpu_torch.flywheel import ShardDataset
    from disco_tpu_torch.flywheel.dataset import peek_geometry
    from disco_tpu_torch.nn.training import create_train_state, fit

    cfg = TrainConfig()
    geom = peek_geometry(args.shards)
    if geom is None:
        raise SystemExit(f"--shards {args.shards}: no intact shard files")
    win_len = args.shard_win_len or geom["block_frames"]
    if win_len > geom["block_frames"]:
        raise SystemExit(
            f"--shard-win-len {win_len} exceeds the tapped block length "
            f"{geom['block_frames']} (windows never cross block boundaries)"
        )
    ds = ShardDataset(args.shards, win_len=win_len, seed=args.seed)
    batch = args.batch_size or cfg.batch_size
    # the arch dict doubles as the generation-store architecture record
    # (--promote-dir): a serve-side GenerationStore.load rebuilds this
    # exact model from it
    arch = dict(n_ch=1, win_len=win_len, n_freq=geom["n_freq"],
                learning_rate=cfg.lr, ff_units=(geom["n_freq"],))
    model, tx = _build(arch, args.seed, device)
    if model.conv_output_hw()[0] < 1:
        raise SystemExit(
            f"--shard-win-len {win_len} is too short for the canonical CRNN "
            "conv stack (three VALID 3-kernels eat 6 frames): use >= 7, or "
            "tap longer blocks — an empty loss slice trains on NaNs"
        )
    first = next(ds.batches(1, epoch=0), None)
    if first is None:
        raise SystemExit(f"--shards {args.shards}: shards hold no windows "
                         f"of {win_len} frames")
    state = create_train_state(model, tx, first[0], seed=args.seed)

    world, mesh_of = _mesh_lane(args, device)
    with world:
        state, train_losses, val_losses, run_name = fit(
            model, state,
            ds.batch_fn(batch, shuffle=True, ledger=args.ledger),
            ds.batch_fn(batch, shuffle=False),
            n_epochs=args.n_epochs,
            save_path=args.save_path,
            output_frames=cfg.output_frames,
            resume_from=none_str(args.weights),
            patience=cfg.early_stop_patience,
            ledger=args.ledger,
            precision=args.precision,
            promote_dir=args.promote_dir,
            promote_arch=arch if args.promote_dir else None,
            device=device,
            mesh=mesh_of(),
        )
    print(f"run {run_name}: best val loss {np.nanmin(val_losses):.6f}")
    return run_name


def _run(args, device):
    if args.shards is not None:
        return _run_shards(args, device)
    from disco_tpu_torch.nn.data import DiscoDataset, get_input_lists, load_input_lists
    from disco_tpu_torch.nn.training import create_train_state, fit

    cfg = TrainConfig()
    rng = np.random.default_rng(args.seed)

    z_sigs = None if args.single_channel else args.zsigs
    if none_str(args.files_to_load) is not None:
        lists = load_input_lists(args.files_to_load)
    else:
        lists = get_input_lists(
            args.path_data,
            rirs_to_get=range(1, args.n_files),
            scenes=[args.scene],
            noise_to_get=args.noise,
            z_sigs=z_sigs,
            z_file=args.zfile,
            rng=rng,
        )

    # single-channel: stack_axis 0; multichannel: z's on the channel axis
    # for the CRNN (3-D input) or on the freq axis for the 2-D RNN
    # (reference train.py:73-74)
    if args.single_channel:
        stack_axis = 0
    else:
        stack_axis = 2 if args.archi == "crnn" else 1
    dataset = DiscoDataset(
        lists, stack_axis=stack_axis, win_len=cfg.win_len, win_hop=cfg.win_hop, rng=rng
    )
    n_val = max(1, int(cfg.val_split * len(dataset)))
    idx = rng.permutation(len(dataset))
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    batch = args.batch_size or cfg.batch_size

    def subset_batches(indices, shuffle):
        def gen():
            order = rng.permutation(indices) if shuffle else indices
            for start in range(0, len(order), batch):
                sel = order[start : start + batch]
                xs, ys = zip(*(dataset[int(i)] for i in sel))
                yield np.stack(xs), np.stack(ys)

        return gen

    n_ch = 1 if args.single_channel else 1 + dataset.z_nodes
    arch = dict(n_ch=n_ch, win_len=cfg.win_len, n_freq=cfg.ff_units,
                learning_rate=cfg.lr)
    if args.archi != "crnn" and args.promote_dir:
        raise SystemExit(
            "--promote-dir: only the CRNN architecture can be staged "
            "as a serve weight generation (the serve model lane "
            "rebuilds via build_crnn); drop --promote-dir or use "
            "--archi crnn"
        )
    model, tx = _build(arch, args.seed, device, rnn=args.archi != "crnn")
    x0, _ = dataset[0]
    state = create_train_state(model, tx, x0[None], seed=args.seed)

    import contextlib

    from disco_tpu_torch.obs.metrics import trace_to

    trace_cm = trace_to(args.trace_dir) if args.trace_dir else contextlib.nullcontext()
    world, mesh_of = _mesh_lane(args, device)
    with trace_cm, world:
        state, train_losses, val_losses, run_name = fit(
            model, state,
            subset_batches(train_idx, shuffle=True),
            subset_batches(val_idx, shuffle=False),
            n_epochs=args.n_epochs,
            save_path=args.save_path,
            output_frames=cfg.output_frames,
            resume_from=none_str(args.weights),
            patience=cfg.early_stop_patience,
            ledger=args.ledger,
            promote_dir=args.promote_dir,
            promote_arch=arch if args.promote_dir else None,
            device=device,
            mesh=mesh_of(),
        )
    print(f"run {run_name}: best val loss {np.nanmin(val_losses):.6f}")
    return run_name


if __name__ == "__main__":
    main()
