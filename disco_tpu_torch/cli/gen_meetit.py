"""MEETIT dataset generation CLI — N interfering speakers around a table
(the port's ``disco-gen-meetit``; counterpart of
``disco_tpu/cli/gen_meetit.py``).

Mirrors reference ``dataset_generation/gen_meetit/convolve_signals.py:210-302``
(flags --dset/--rirs/--n_src/--dir_out; the start-time stagger sleep is not
needed — idempotency guards make parallel shards collision-free).  The
RIRs, convolutions and masks run on ``--device`` (``datagen.meetit``)."""
from __future__ import annotations

import argparse

import numpy as np

from disco_tpu_torch.cli.common import add_device_arg, add_rirs_arg
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-gen-meetit`` argument parser."""
    p = argparse.ArgumentParser(description="Generate MEETIT meeting-room mixtures")
    p.add_argument("--dset", choices=["train", "val", "test"], default="test")
    add_rirs_arg(p)
    p.add_argument("--n_src", "-n", type=int, default=2, help="number of interfering speakers (= nodes)")
    p.add_argument("--dir_out", "-do", default="dataset/meetit/", help="corpus root")
    p.add_argument("--librispeech", default="dataset/LibriSpeech/", help="LibriSpeech root")
    p.add_argument("--max_order", type=int, default=20)
    p.add_argument("--duration", nargs=2, type=float, default=[5, 10],
                   help="min/max clip duration in seconds (convolve_signals.py:404)")
    p.add_argument("--seed", type=int, default=30)
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-gen-meetit`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from disco_tpu_torch.datagen.disco import get_wavs_list
    from disco_tpu_torch.datagen.meetit import generate_meetit_rirs
    from disco_tpu_torch.io.layout import DatasetLayout
    from disco_tpu_torch.sim.signals import InterferentSpeakersSetup

    rir_start, n_rirs = args.rirs
    rng = np.random.default_rng(args.seed + rir_start)
    targets, _talkers, _ = get_wavs_list(
        args.librispeech, None, dset=args.dset, cache_dir=f"{args.dir_out}/log/lists"
    )
    if not targets:
        raise SystemExit(f"no speech files found under {args.librispeech}")
    signal_setup = InterferentSpeakersSetup(
        speakers_list=targets,
        duration_range=tuple(args.duration),
        var_tar=10 ** (-23 / 10),
        snr_dry_range=[[0, 0]],
        snr_cnv_range=(-10, 15),
        min_delta_snr=0.0,
        rng=rng,
    )
    layout = DatasetLayout(args.dir_out, "meetit", args.dset)
    done = generate_meetit_rirs(
        args.n_src, args.dset, rir_start, n_rirs, signal_setup, layout,
        rng=rng, max_order=args.max_order, device=device,
    )
    print(f"generated {len(done)} RIRs: {done}")
    return done


if __name__ == "__main__":
    main()
