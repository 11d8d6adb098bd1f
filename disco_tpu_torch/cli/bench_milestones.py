"""Milestone benchmark CLI (the port's ``disco-torch-milestones``;
counterpart of ``disco_tpu/cli/bench_milestones.py``): run the BASELINE
configurations 1-5 plus the streaming-latency config 6
(``disco_tpu_torch.milestones``), and optionally the self-generated-corpus
pipeline, printing one JSON line per config.

No reference counterpart: the reference repo ships no benchmark CLI.
"""
from __future__ import annotations

import argparse
import json

from disco_tpu_torch import milestones
from disco_tpu_torch.cli.common import add_device_arg
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-torch-milestones`` argument parser."""
    p = argparse.ArgumentParser(description="Run the BASELINE milestone benchmark configs")
    p.add_argument("--tiny", action="store_true", help="small CPU-testable scales")
    p.add_argument("--configs", nargs="+", type=int, default=None,
                   help="subset of configs to run (1-6; 6 = streaming latency)")
    p.add_argument("--corpus", action="store_true",
                   help="also run the self-generated-corpus pipeline milestone "
                        "(gen→mix→train→tango, disco_tpu_torch.milestones_corpus)")
    p.add_argument("--workdir", default=None, help="corpus milestone working dir")
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-torch-milestones`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.corpus:
        import tempfile

        from disco_tpu_torch.milestones_corpus import corpus_milestone

        workdir = args.workdir or tempfile.mkdtemp(prefix="disco_corpus_milestone_")
        kwargs = dict(n_rirs=2, n_epochs=2, max_order=6) if args.tiny else {}
        res = corpus_milestone(workdir, **kwargs, device=device)
        print(json.dumps(res))  # then the standard configs run as usual
    if args.configs is None and args.tiny:
        results = milestones.run_all(tiny=True, device=device)
    else:
        ids = args.configs or sorted(milestones.CONFIGS)
        results = [milestones.CONFIGS[i](**(milestones.TINY[i] if args.tiny else {}),
                                         device=device) for i in ids]
    for res in results:
        print(json.dumps(res))
    return results


if __name__ == "__main__":
    main()
