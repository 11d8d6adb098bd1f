"""Aggregate per-RIR OIM result pickles into summary statistics (the
port's ``disco-aggregate``; counterpart of ``disco_tpu/cli/aggregate.py``).

The reference pickles ~20 metrics per RIR (tango.py:617-635) and leaves
cross-RIR aggregation entirely to the user, providing only the ``ci_wp``
helper (metrics.py:283) and ``bar_data`` (misc_utils.py:102).  This CLI is
that missing last step: mean ± 95% CI per metric over every RIR in a
results tree, as a table or one JSON line — the numbers that become a
paper table row.  Host numpy only; ``--device`` is checked as in every
port CLI.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from disco_tpu_torch.cli.common import add_device_arg
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-aggregate`` argument parser."""
    p = argparse.ArgumentParser(description="Aggregate per-RIR OIM pickles: mean ± 95% CI per metric")
    p.add_argument("oim_dir", help="OIM directory of a results tree (…/{save_dir}/OIM)")
    p.add_argument("--kind", choices=["tango", "mwf"], default="tango",
                   help="which pickle family to aggregate")
    p.add_argument("--noise", default=None, help="restrict to one noise condition")
    p.add_argument("--keys", nargs="+", default=None, help="subset of metric keys")
    p.add_argument("--json", action="store_true", help="print one JSON line instead of a table")
    add_device_arg(p)
    return p


def summarize(agg: dict, keys=None) -> dict:
    """{key: {mean, ci95, n}} over the stacked per-RIR arrays, NaN-robust
    (the reference's STOI can be NaN on too-short segments)."""
    from disco_tpu_torch.core.metrics import ci_wp

    out = {}
    for key in keys or sorted(agg):
        v = np.asarray(agg[key], np.float64).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            out[key] = {"mean": float("nan"), "ci95": float("nan"), "n": 0}
            continue
        out[key] = {"mean": float(np.mean(v)), "ci95": float(ci_wp(v)), "n": int(v.size)}
    return out


def main(argv=None):
    """``disco-aggregate`` console entry point."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)

    from disco_tpu_torch.enhance.driver import aggregate_results

    agg = aggregate_results(args.oim_dir, kind=args.kind, noise=args.noise)
    if not agg:
        print(f"no results_{args.kind}_* pickles under {args.oim_dir}")
        return {}
    summary = summarize(agg, keys=args.keys)
    if args.json:
        print(json.dumps(summary))
    else:
        width = max(len(k) for k in summary)
        print(f"{'metric':<{width}}  {'mean':>9}  {'±95% CI':>9}  {'n':>5}")
        for key, s in summary.items():
            print(f"{key:<{width}}  {s['mean']:>9.3f}  {s['ci95']:>9.3f}  {s['n']:>5}")
    return summary


if __name__ == "__main__":
    main()
