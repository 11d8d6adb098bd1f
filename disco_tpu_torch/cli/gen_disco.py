"""DISCO dataset generation CLI — rooms, RIRs, convolved sources (the
port's ``disco-gen``; counterpart of ``disco_tpu/cli/gen_disco.py``).

Mirrors reference ``dataset_generation/gen_disco/convolve_signals.py:329-448``
(flags --dset/--scenario/--rirs/--dir_out; the reference's ``args.rir_id``
flag-mismatch bug is not reproduced, SURVEY.md §7).  The RIRs and
convolutions run on ``--device`` (``datagen.disco``)."""
from __future__ import annotations

import argparse

import numpy as np

from disco_tpu_torch.cli.common import (
    add_device_arg,
    add_ledger_arg,
    add_resume_arg,
    add_rirs_arg,
    add_scenario_arg,
)
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-gen`` argument parser."""
    p = argparse.ArgumentParser(description="Generate DISCO rooms + convolved signals")
    p.add_argument("--dset", choices=["train", "test"], default="test")
    add_scenario_arg(p)
    add_rirs_arg(p)
    p.add_argument("--dir_out", "-d", default="dataset/disco/", help="corpus root")
    p.add_argument("--librispeech", default="dataset/LibriSpeech/", help="LibriSpeech root")
    p.add_argument("--freesound", default=None, help="Freesound noise wav directory")
    p.add_argument("--max_order", type=int, default=20, help="ISM reflection order")
    p.add_argument("--duration", nargs=2, type=float, default=[5, 10],
                   help="min/max clip duration in seconds (convolve_signals.py:404)")
    p.add_argument("--seed", type=int, default=30, help="global seed (convolve_signals.py:330)")
    p.add_argument("--batched", action="store_true",
                   help="batched scenario factory: one RIR-engine call per "
                        "--batch scenes (datagen.disco."
                        "generate_disco_rirs_batched) instead of one per scene")
    p.add_argument("--batch", type=int, default=8,
                   help="scenes per batched call (with --batched)")
    add_ledger_arg(p, "scene",
                   default_hint="<dir_out>/log/ledger_<scenario>_<dset>.jsonl")
    add_resume_arg(p, "scene", regen="regenerated")
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-gen`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from disco_tpu_torch.datagen.disco import generate_disco_rirs, get_wavs_list
    from disco_tpu_torch.io.layout import DatasetLayout
    from disco_tpu_torch.sim.signals import SpeechAndNoiseSetup

    rir_start, n_rirs = args.rirs
    if args.ledger is None and args.resume:
        args.ledger = f"{args.dir_out}/log/ledger_{args.scenario}_{args.dset}.jsonl"
    rng = np.random.default_rng(args.seed)
    targets, talkers, noises = get_wavs_list(
        args.librispeech, args.freesound, dset=args.dset, cache_dir=f"{args.dir_out}/log/lists"
    )
    if not targets:
        raise SystemExit(f"no speech files found under {args.librispeech}")
    signal_setup = SpeechAndNoiseSetup(
        target_list=targets,
        talkers_list=talkers,
        noises_dict=noises,
        duration_range=tuple(args.duration),
        var_tar=10 ** (-23 / 10),
        snr_dry_range=[[0, 0]],
        snr_cnv_range=(-10, 15),
        min_delta_snr=0.0,
        rng=rng,
    )
    layout = DatasetLayout(args.dir_out, args.scenario, args.dset)
    from disco_tpu_torch.runs import GracefulInterrupt

    with GracefulInterrupt() as stopped:
        if args.batched:
            from disco_tpu_torch.datagen.disco import generate_disco_rirs_batched

            done = generate_disco_rirs_batched(
                args.scenario, args.dset, rir_start, n_rirs, signal_setup,
                layout, rng=rng, max_order=args.max_order,
                ledger=args.ledger, resume=args.resume, batch=args.batch,
                seed=args.seed, device=device,
            )
        else:
            done = generate_disco_rirs(
                args.scenario, args.dset, rir_start, n_rirs, signal_setup, layout,
                rng=rng, max_order=args.max_order,
                ledger=args.ledger, resume=args.resume, device=device,
            )
    if stopped():
        print("interrupted — generation is resumable: rerun the same command "
              "(idempotent; add --resume for digest-verified skips)")
    print(f"generated {len(done)} RIRs: {done}")
    return done


if __name__ == "__main__":
    main()
