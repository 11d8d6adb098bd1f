"""Mixing-pass CLI (PostGenerator) — target + noise at random SNR, STFTs,
ideal masks (the port's ``disco-mix``; counterpart of
``disco_tpu/cli/mix.py``).

Mirrors reference ``gen_disco/mix_convolved_signals.py:9-33`` (the
``args.scene`` vs ``--scenario`` flag-mismatch bug is not reproduced,
SURVEY.md §7).  The STFTs run on ``--device`` (the f32 STFT kernel on the
card, ``datagen.postgen``)."""
from __future__ import annotations

import argparse

from disco_tpu_torch.cli.common import (
    add_device_arg,
    add_noise_arg,
    add_rirs_arg,
    add_scenario_arg,
    snr_value,
)
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-mix`` argument parser."""
    p = argparse.ArgumentParser(description="Mix convolved signals into the processed corpus")
    add_rirs_arg(p)
    add_scenario_arg(p)
    add_noise_arg(p)
    p.add_argument("--dir", "-d", dest="root", default="dataset/disco/", help="corpus root")
    p.add_argument("--snr", nargs=2, type=snr_value, default=[0, 6], help="mixture SNR range (tango.py:37)")
    p.add_argument("--no_target", action="store_true", help="skip saving clean target outputs")
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-mix`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from disco_tpu_torch.datagen.postgen import PostGenerator

    rir_start, n_rirs = args.rirs
    pg = PostGenerator(
        rir_start, n_rirs, args.scenario, args.noise, args.snr, args.root,
        save_target=not args.no_target, device=device,
    )
    pg.post_process()
    return pg


if __name__ == "__main__":
    main()
