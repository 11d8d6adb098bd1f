"""Self-generated-corpus milestone on the card (counterpart of
``disco_tpu/milestones_corpus.py``): the complete reference workflow —
disco-gen → disco-mix → z-export → CRNN training → disco-tango — through
the port's command line, on corpus-shaped data produced by the port's OWN
generation pipeline, reporting ΔSI-SDR for oracle and trained-CRNN masks.

No LibriSpeech or Freesound material is at hand, so the speech tree is
synthesized (harmonic speech-like signals in the LibriSpeech directory
layout, drawn on the host in numpy and scipy exactly as the JAX package
draws them, so both packages write the same WAV bytes from a seed);
everything downstream of it is the real pipeline: ISM room simulation,
SNR-gated mixing, per-RIR idempotent file layout, list building, training,
and the enhancement driver with its full metric set.

``device``: every CLI gets ``--device`` (``cuda`` when None; RuntimeError
without a CUDA device, ``"cpu"`` for the plain versions on the host).
"""
from __future__ import annotations

import numpy as np

from disco_tpu_torch.device import resolve_device

FS = 16000


def _speechlike(rng, n: int, fs: int = FS, f0_base: float = 140.0) -> np.ndarray:
    """Harmonic speech-like signal: pitched harmonic source with a wandering
    f0, two random formant resonances per 'syllable', a small aspiration
    noise floor, and a pause-structured envelope.

    Harmonic structure is what makes the reference's mask-learning task
    work: amplitude-modulated white noise is spectrally identical to the
    SSN noise it is mixed against, so its IRM is nearly unpredictable from
    mixture spectra and a mask CRNN trained on it collapses to the mean
    mask."""
    from scipy.signal import lfilter

    t = np.arange(n) / fs
    # wandering pitch: slow vibrato + per-utterance drift
    f0 = f0_base * (1.0 + 0.15 * np.sin(2 * np.pi * 2.7 * t + rng.uniform(0, 7)))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    src = np.zeros(n)
    for h in range(1, 13):  # sawtooth-ish rolloff
        src += np.sin(h * phase + rng.uniform(0, 7)) / h
    # syllabic segments: each gets its own 2 formant resonators
    out = np.zeros(n)
    seg = int(0.22 * fs)
    for a in range(0, n, seg):
        b = min(a + seg, n)
        x = src[a:b] + 0.1 * rng.standard_normal(b - a)  # aspiration floor
        for fmt in rng.uniform([350, 900], [900, 2600]):
            r = 0.97
            th = 2 * np.pi * fmt / fs
            x = lfilter([1.0 - r], [1.0, -2 * r * np.cos(th), r * r], x)
        out[a:b] = x
    env = (np.sin(2 * np.pi * rng.uniform(1.0, 1.6) * t + rng.uniform(0, 7)) > -0.3).astype(np.float64)
    out = env * out
    peak = np.max(np.abs(out))
    return 0.4 * out / (peak + 1e-9)


def synth_speech_tree(root, n_speakers: int = 3, dur_s: float = 6.0, seed: int = 0):
    """LibriSpeech-shaped tree of synthetic harmonic speech-like signals
    (see :func:`_speechlike`), covering the three splits disco-gen globs."""
    from disco_tpu_torch.io import write_wav

    rng = np.random.default_rng(seed)
    n = int(dur_s * FS)
    for i in range(n_speakers):
        spk = str(19 + 7 * i)
        f0_base = 110.0 * 2 ** rng.uniform(0.0, 0.8)  # per-speaker register
        for split in ("train-clean-100", "train-clean-360", "test-clean"):
            d = root / split / spk / "1"
            d.mkdir(parents=True, exist_ok=True)
            write_wav(d / f"{spk}-1-0001.wav", _speechlike(rng, n, f0_base=f0_base), FS)
    return root


def _delta_from_results(res: dict) -> dict:
    """Mean output-minus-input deltas over nodes, both BSS metric families."""
    return {
        "delta_sdr_512tap": float(np.mean(res["sdr_cnv"] - res["sdr_in_cnv"])),
        "delta_si_sdr": float(np.mean(res["si_sdr_cnv"] - res["si_sdr_in_cnv"])),
        "delta_stoi": float(np.mean(res["delta_stoi_cnv"])),
    }


def corpus_milestone(
    workdir,
    n_rirs: int = 4,
    n_epochs: int = 8,
    scenario: str = "random",
    noise: str = "ssn",
    max_order: int = 8,
    seed: int = 0,
    device=None,
):
    """Run the full generate→mix→z→train→enhance pipeline under ``workdir``
    through the port's CLIs and score oracle vs trained-CRNN TANGO on the
    generated material (train-set scoring: the tiny corpus has no held-out
    split).  ``disco-tango --mods`` loads the two trained CRNNs from their
    msgpack checkpoints (the JAX package's format).

    Returns a dict with ``tango_4node_oracle`` and ``tango_4node_crnn``
    entries (mean over nodes and RIRs of output-minus-input SDR / SI-SDR /
    STOI deltas).
    """
    from pathlib import Path

    from disco_tpu_torch.cli import gen_disco, get_z, mix, tango, train
    from disco_tpu_torch.enhance.driver import aggregate_results

    dev = ["--device", resolve_device(device).type]
    workdir = Path(workdir)
    speech = synth_speech_tree(workdir / "libri", seed=seed)
    data = workdir / "dataset"

    gen_disco.main([
        "--dset", "train", "--scenario", scenario, "--rirs", "1", str(n_rirs),
        "--dir_out", str(data), "--librispeech", str(speech),
        "--max_order", str(max_order), "--seed", str(30 + seed), *dev,
    ])
    mix.main([
        "--rirs", "1", str(n_rirs), "--scenario", scenario, "--noise", noise,
        "--dir", str(data), "--snr", "0", "6", *dev,
    ])
    for rir in range(1, n_rirs + 1):
        get_z.main([
            "--rir", str(rir), "--scenario", scenario, "--noise", noise,
            "--dataset", str(data), "--sav_dir", "oracle", *dev,
        ])

    models_dir = workdir / "models"
    # train.py's n_files is EXCLUSIVE (reference convention: 11001 for
    # 11000 rirs), so n_rirs + 1 trains on every generated RIR
    mc_name = train.main([
        "--scene", scenario, "--noise", noise, "--n_files", str(n_rirs + 1),
        "--path_data", str(data), "--save_path", str(models_dir),
        "--n_epochs", str(n_epochs), "--batch_size", "32", "--zsigs", "zs_hat", *dev,
    ])
    sc_name = train.main([
        "--scene", scenario, "--noise", noise, "--n_files", str(n_rirs + 1),
        "--path_data", str(data), "--save_path", str(models_dir),
        "--n_epochs", str(n_epochs), "--batch_size", "32", "--single_channel", *dev,
    ])

    out_oracle = workdir / "results_oracle"
    out_crnn = workdir / "results_crnn"
    for rir in range(1, n_rirs + 1):
        tango.main([
            "--rir", str(rir), "--scenario", scenario, "--noise", noise,
            "--dataset", str(data), "--out_root", str(out_oracle), "--sav_dir", "o", *dev,
        ])
        tango.main([
            "--rir", str(rir), "--scenario", scenario, "--noise", noise,
            "--dataset", str(data), "--out_root", str(out_crnn), "--sav_dir", "c",
            "--mods", str(models_dir / f"{sc_name}_model.msgpack"),
            str(models_dir / f"{mc_name}_model.msgpack"), *dev,
        ])

    agg_oracle = aggregate_results(out_oracle / "OIM", kind="tango", noise=noise)
    agg_crnn = aggregate_results(out_crnn / "OIM", kind="tango", noise=noise)
    return {
        "config": "corpus_pipeline",
        "rirs": n_rirs,
        "epochs": n_epochs,
        "tango_4node_oracle": _delta_from_results(agg_oracle),
        "tango_4node_crnn": _delta_from_results(agg_crnn),
    }


def meetit_corpus_milestone(
    workdir,
    n_rirs: int = 2,
    n_src: int = 2,
    max_order: int = 8,
    seed: int = 0,
    device=None,
):
    """MEETIT on real pipeline data: generate meeting-room mixtures with the
    disco-gen-meetit CLI, then run mask-driven separation on the SAVED
    artifacts (mix STFTs + per-source IRMs — the corpus→separation bridge of
    the ICASSP 2021 use case) on the device, and score each source AT ITS
    OWN NODE against the saved clean convolved images (the reference's
    evaluation semantics).

    Returns the config-4 numbers from generated corpus material: headline
    ΔSI-SIR (interference rejection — the own-node mixture is already
    source-dominated, so SIR is where separation shows) plus ΔSI-SDR,
    each estimate-minus-mixture-baseline, averaged over sources and RIRs.
    """
    from pathlib import Path

    import torch

    from disco_tpu_torch.cli import gen_meetit
    from disco_tpu_torch.core.dsp import istft
    from disco_tpu_torch.core.metrics import si_bss, si_sdr
    from disco_tpu_torch.datagen.meetit import load_meetit_sample, node_channel_bounds
    from disco_tpu_torch.enhance.separation import separate_with_masks
    from disco_tpu_torch.io import DatasetLayout, read_wav

    dev = resolve_device(device)
    workdir = Path(workdir)
    speech = synth_speech_tree(workdir / "libri", n_speakers=3 * n_src, seed=seed)
    data = workdir / "meetit"

    gen_meetit.main([
        "--dset", "test", "--rirs", "1", str(n_rirs), "--n_src", str(n_src),
        "--dir_out", str(data), "--librispeech", str(speech),
        "--max_order", str(max_order), "--duration", "2", "3",
        "--seed", str(30 + seed), "--device", dev.type,
    ])

    layout = DatasetLayout(str(data), "meetit", "test")
    mics_per_node = [4] * n_src
    bounds = node_channel_bounds(mics_per_node)
    deltas = []
    for rir in range(1, n_rirs + 1):
        Y, masks = (torch.as_tensor(a, device=dev)
                    for a in load_meetit_sample(layout, rir, mics_per_node))
        est = separate_with_masks(Y, masks, policy="distant", device=dev)
        # Source s scored at ITS OWN node s — the reference's evaluation
        # semantics (each source directly faces one node; per-source SIR is
        # computed at that node, gen_meetit/convolve_signals.py:140-148).
        for s in range(n_src):
            ref_ch = int(bounds[s]) + 1
            imgs = np.stack([
                np.asarray(
                    read_wav(layout.base / "wav" / "clean" / "cnv" / f"{rir}_S-{j + 1}_Ch-{ref_ch}.wav")[0],
                    np.float64,
                )
                for j in range(n_src)
            ], axis=1)  # (n_samples, n_src) targets for si_bss
            T_samples = imgs.shape[0]
            ref = imgs[:, s]
            est_t = istft(est[s, s], length=T_samples).cpu().numpy().astype(np.float64)
            mix_t = istft(Y[s, 0], length=T_samples).cpu().numpy().astype(np.float64)
            _, sir_out, _ = si_bss(est_t, imgs, s)
            _, sir_in, _ = si_bss(mix_t, imgs, s)
            deltas.append({
                "si_sdr": float(si_sdr(ref, est_t) - si_sdr(ref, mix_t)),
                "si_sir": float(sir_out - sir_in),
            })
    sdrs = [d["si_sdr"] for d in deltas]
    sirs = [d["si_sir"] for d in deltas]
    return {
        "config": "meetit_corpus_separation",
        "rirs": n_rirs,
        "n_src": n_src,
        "delta_si_sir_mean": float(np.mean(sirs)),
        "delta_si_sir_min": float(np.min(sirs)),
        "delta_si_sdr_mean": float(np.mean(sdrs)),
        "delta_si_sdr_min": float(np.min(sdrs)),
        "pairs_scored": len(deltas),
    }


def build_parser():
    """Build the ``disco-torch-milestones-corpus`` argument parser."""
    import argparse

    from disco_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description="generate→mix→train→enhance corpus milestone")
    p.add_argument("--workdir", default=None, help="working directory (default: temp)")
    p.add_argument("--rirs", type=int, default=4)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--scenario", default="random")
    p.add_argument("--noise", default="ssn")
    p.add_argument("--meetit", action="store_true",
                   help="also run the MEETIT separation milestone on generated corpus material")
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-torch-milestones-corpus`` console entry point."""
    import json
    import tempfile

    args = build_parser().parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="disco_corpus_milestone_")
    out = corpus_milestone(workdir, n_rirs=args.rirs, n_epochs=args.epochs,
                           scenario=args.scenario, noise=args.noise, device=args.device)
    print(json.dumps(out))
    if args.meetit:
        out_m = meetit_corpus_milestone(workdir, n_rirs=args.rirs, device=args.device)
        print(json.dumps(out_m))
        out = {"disco": out, "meetit": out_m}
    return out


if __name__ == "__main__":
    main()
