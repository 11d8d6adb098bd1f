"""Z-signal export CLI — step 1 only, producing CRNN training inputs (the
port's ``disco-get-z``; counterpart of ``disco_tpu/cli/get_z.py``).

Mirrors reference ``speech_enhancement/get_z_signals.py:363-404`` (flags
--vad_type/--sav_dir/--rir/--scenario/--noise/--mask_z/--mod_sc; the
``load_models`` arity bug and the stale-file '.npy' check bug are not
reproduced, SURVEY.md §7).  The STFT, covariances and solve run on
``--device`` (``enhance.zexport.export_z``)."""
from __future__ import annotations

import argparse

from disco_tpu_torch.cli.common import (
    add_device_arg,
    add_rirs_arg,
    none_str,
    snr_value,
)
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-get-z`` argument parser."""
    p = argparse.ArgumentParser(description="Export compressed z signals (TANGO step 1)")
    p.add_argument("--vad_type", "-vt", default="irm1")
    p.add_argument("--sav_dir", "-sd", default="oracle", help="zfile name under stft_z/")
    p.add_argument("--rir", type=int, default=None, help="single RIR id (overrides --rirs)")
    add_rirs_arg(p)
    p.add_argument("--scenario", "-scene", choices=["living", "meeting", "random"], default="living")
    p.add_argument("--noise", choices=["ssn", "it", "fs"], default="fs")
    p.add_argument("--mod_sc", "-msc", default="None", help="single-channel CRNN checkpoint or None")
    p.add_argument("--dataset", default="dataset/disco/", help="corpus root")
    p.add_argument("--snr", nargs=2, type=snr_value, default=[0, 6])
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-get-z`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from disco_tpu_torch.enhance.zexport import export_z

    rirs = [args.rir] if args.rir is not None else range(args.rirs[0], args.rirs[0] + args.rirs[1])
    masks_fn = None
    if none_str(args.mod_sc) is not None:
        from disco_tpu_torch.cli.tango import _load_model

        model = _load_model(args.mod_sc, archi="crnn", device=device)

        def masks_fn(Y):
            from disco_tpu_torch.enhance.inference import crnn_masks_batched

            # all node forwards in one batched call, kept on the device
            return crnn_masks_batched(Y[:, 0], model, device=device)

    n_done = 0
    for rir in rirs:
        try:
            done = export_z(
                args.dataset, args.scenario, rir, args.noise,
                snr_range=tuple(args.snr), zfile=args.sav_dir,
                mask_type=args.vad_type, masks_fn=masks_fn, device=device,
            )
        except FileNotFoundError:
            print(f"{rir}: input signals missing, skipped")
            continue
        n_done += bool(done)
        print(f"{rir} {'done' if done else 'already processed'}")
    return n_done


if __name__ == "__main__":
    main()
