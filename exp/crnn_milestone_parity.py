"""Do the JAX package's trained CRNNs score as the port's do?

Runs the corpus milestone (generate -> mix -> z -> train -> TANGO, oracle
masks against the two trained CRNNs' masks) of both packages on the host
at the same defaults: 4 RIRs of 4 x 4 mics at image order 8, 8 epochs at
batch 32, seed 0:

* ``jax``: ``disco_tpu.milestones_corpus.corpus_milestone`` on the CPU
  (``JAX_PLATFORMS=cpu``);
* ``port``: ``disco_tpu_torch.milestones_corpus.corpus_milestone(...,
  device="cpu")``.

``PostGenerator`` draws its SNR unseeded in both packages
(``disco_tpu/datagen/postgen.py:54``, ``disco_tpu_torch/datagen/postgen.py:61``),
so each package runs ``--runs`` times (alternating jax, port, jax, ...) and
the verdict reads the spread.  With ``--snr-seed S`` run ``i`` of both
packages draws its SNRs from ``np.random.default_rng(S + i)`` (each
``PostGenerator`` built with no ``rng`` is given that generator), so the two
packages train and score on the same mixtures and a run's pair differs only
by the packages' training and enhancement.  ``--arms`` adds two port
variants that bisect the training: ``port-torchinit`` (the port's CRNNs
drawn in torch's default initializer scheme, uniform kernels and biases,
as the port drew them before it took flax's scheme, which ``port`` draws)
and ``port-jaxinit`` (the port's CRNNs started from the JAX package's own
initial weights for the same seed, through ``nn.convert``).  ``--train-seed N`` passes ``--seed N`` to both packages'
``train`` commands (the initial weights, the split and the shuffle; the
CLIs' default is 26).  Each run prints one JSON line with the
oracle's and the CRNNs' delta SDR (512-tap), delta SI-SDR and delta STOI
and its seconds; the last line is the summary (per package: min, mean,
max).  With ``--out`` the lines also go to that file as they come.

Run from the repo root (one run of each takes minutes on the host)::

    JAX_PLATFORMS=cpu python exp/crnn_milestone_parity.py [--runs 3] [--out FILE] \
        [--snr-seed S] [--train-seed N] \\
        [--arms jax,port,port-torchinit,port-jaxinit]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEYS = ("delta_sdr_512tap", "delta_si_sdr", "delta_stoi")
ENTRIES = ("tango_4node_oracle", "tango_4node_crnn")


def seeded_snrs(postgen_class, seed):
    """Give every ``postgen_class`` built without an ``rng`` the generator
    ``np.random.default_rng(seed)``; returns the undo."""
    import numpy as np

    init = postgen_class.__init__

    def seeded(self, *args, rng=None, **kwargs):
        init(self, *args, rng=np.random.default_rng(seed) if rng is None else rng, **kwargs)

    postgen_class.__init__ = seeded
    return lambda: setattr(postgen_class, "__init__", init)


def torch_default_init(model) -> None:
    """Redraw ``model``'s weights in torch's default scheme, layer by layer
    in construction order (each layer's ``reset_parameters``), then zero
    the biases flax's cells lack (a GRU's hidden-side r and z rows): after
    ``torch.manual_seed(seed)`` this is the CRNN the port built from
    ``seed`` before it drew flax's scheme."""
    import torch
    from torch import nn

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.RNNBase)):
                m.reset_parameters()
            if isinstance(m, nn.GRU):
                m.bias_hh_l0[:2 * m.hidden_size] = 0.0


def patch_port_init(arm: str):
    """Make the port's ``disco-torch-train`` build its CRNNs as ``arm``
    says ('port-torchinit' or 'port-jaxinit'); returns the
    undo."""
    from disco_tpu_torch.cli import train as tcli
    from disco_tpu_torch.nn import training as ttraining

    build, create = tcli._build, ttraining.create_train_state

    def patched_build(arch, seed, device, rnn=False):
        model, tx = build(arch, seed, device, rnn=rnn)
        model._parity_arch = dict(arch)
        if arm == "port-torchinit":
            import torch

            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                torch_default_init(model)
        return model, tx

    def patched_create(model, tx, sample_input=None, seed=0):
        if arm == "port-jaxinit" and hasattr(model, "_parity_arch"):  # not a loaded model
            import numpy as np
            import torch

            from disco_tpu.nn.crnn import build_crnn
            from disco_tpu.nn.training import create_train_state
            from disco_tpu_torch.nn.convert import state_dict_from_flax

            jmodel, jtx = build_crnn(**model._parity_arch)
            jstate = create_train_state(jmodel, jtx, np.asarray(sample_input), seed=seed)
            sd = state_dict_from_flax({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}, model)
            dev = next(model.parameters()).device
            with torch.no_grad():
                model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
        return create(model, tx, sample_input, seed=seed)

    tcli._build, ttraining.create_train_state = patched_build, patched_create

    def undo():
        tcli._build, ttraining.create_train_state = build, create

    return undo


def seeded_training(train_module, seed):
    """Append ``--seed seed`` to every ``train_module.main`` call; returns
    the undo."""
    main = train_module.main
    train_module.main = lambda argv=None: main(list(argv) + ["--seed", str(seed)])
    return lambda: setattr(train_module, "main", main)


def run_once(arm: str, workdir: str, snr_seed: int | None = None,
             train_seed: int | None = None) -> dict:
    """One corpus milestone of ``arm`` ('jax', 'port', 'port-torchinit' or
    'port-jaxinit') at the defaults."""
    if arm == "jax":
        from disco_tpu.cli import train as train_module
        from disco_tpu.datagen.postgen import PostGenerator
        from disco_tpu.milestones_corpus import corpus_milestone

        kwargs = {}
    else:
        from disco_tpu_torch.cli import train as train_module
        from disco_tpu_torch.datagen.postgen import PostGenerator
        from disco_tpu_torch.milestones_corpus import corpus_milestone

        kwargs = {"device": "cpu"}
    undo = [seeded_snrs(PostGenerator, snr_seed) if snr_seed is not None else (lambda: None)]
    if train_seed is not None:
        undo.append(seeded_training(train_module, train_seed))
    if arm in ("port-torchinit", "port-jaxinit"):
        undo.append(patch_port_init(arm))
    try:
        return corpus_milestone(workdir, **kwargs)
    finally:
        for u in undo:
            u()


def summary(lines: list[dict]) -> dict:
    """Per package and entry, each key's min, mean and max over the runs."""
    out = {}
    for package in dict.fromkeys(ln["package"] for ln in lines):
        runs = [ln for ln in lines if ln["package"] == package]
        out[package] = {
            entry: {key: {"min": min(r[entry][key] for r in runs),
                          "mean": sum(r[entry][key] for r in runs) / len(runs),
                          "max": max(r[entry][key] for r in runs)} for key in KEYS}
            for entry in ENTRIES} if runs else {}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=3, help="runs of each package")
    p.add_argument("--out", default=None, help="also append the JSON lines to this file")
    p.add_argument("--snr-seed", type=int, default=None,
                   help="run i of both packages draws its SNRs from seed SNR_SEED + i")
    p.add_argument("--train-seed", type=int, default=None,
                   help="--seed of both packages' train commands (default: theirs, 26)")
    p.add_argument("--first-run", type=int, default=0,
                   help="index of the first run (its SNR seed is SNR_SEED + index)")
    p.add_argument("--arms", default="jax,port",
                   help="comma-separated: jax, port, port-torchinit, port-jaxinit")
    args = p.parse_args(argv)
    lines = []
    for i in range(args.first_run, args.first_run + args.runs):
        for package in args.arms.split(","):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix=f"crnn_parity_{package}_") as work:
                res = run_once(package, work,
                               None if args.snr_seed is None else args.snr_seed + i,
                               args.train_seed)
            line = {"package": package, "run": i, "snr_seed": args.snr_seed,
                    "train_seed": args.train_seed,
                    "seconds": time.perf_counter() - t0,
                    **{entry: {k: float(res[entry][k]) for k in KEYS} for entry in ENTRIES}}
            lines.append(line)
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(text + "\n")
    text = json.dumps({"summary": summary(lines)})
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
