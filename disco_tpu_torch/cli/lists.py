"""Input-lists CLI — build and persist the per-signal .npy path lists used
for training and for rsync-style dataset staging (the port's
``disco-lists``; counterpart of ``disco_tpu/cli/lists.py``).

Mirrors reference ``dnn/data/lists_to_load.py:43-89`` (write txt lists
consumable by ``rsync --files-from``, reference exp/ex1/oar_train.sh:28-45).
Host numpy only; ``--device`` is checked as in every port CLI.
"""
from __future__ import annotations

import argparse

import numpy as np

from disco_tpu_torch.cli.common import add_device_arg
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-lists`` argument parser."""
    p = argparse.ArgumentParser(description="Write training input file lists")
    p.add_argument("--scene", nargs="+", default=["living"])
    p.add_argument("--noise", default="ssn")
    p.add_argument("--zsigs", "-zs", nargs="+", default=["zs_hat"])
    p.add_argument("--zfile", "-zf", default="oracle")
    p.add_argument("--n_files", "-n", type=int, default=11001)
    p.add_argument("--path_data", "-path", default="dataset/disco/")
    p.add_argument("--out", "-o", default="lists/", help="folder for the txt lists")
    p.add_argument("--seed", type=int, default=26)
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-lists`` console entry point."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    from disco_tpu_torch.nn.data import get_input_lists, write_input_lists

    lists = get_input_lists(
        args.path_data,
        rirs_to_get=range(1, args.n_files),
        scenes=args.scene,
        noise_to_get=args.noise,
        z_sigs=args.zsigs,
        z_file=args.zfile,
        rng=np.random.default_rng(args.seed),
    )
    write_input_lists(lists, args.out)
    print(f"wrote {len(lists)} lists ({len(lists[0])} entries each) to {args.out}")
    return lists


if __name__ == "__main__":
    main()
