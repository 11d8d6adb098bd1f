"""A miniature processed corpus for driving the corpus driver (counterpart
of ``disco_tpu/runs/check.py::_mini_corpus``).

The port's tests and ``chip_smoke.py`` build their corpora here; at the JAX
helper's defaults (4 nodes × 2 mics, 2-s clips) the files are byte-identical
to that helper's.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from disco_tpu_torch.io.atomic import save_npy_atomic, write_wav_atomic
from disco_tpu_torch.io.layout import DatasetLayout

FS = 16000
K, C = 4, 2  # nodes x mics-per-node
RIRS = (11001, 11002)  # test-split ids
NOISE = "ssn"
SNR_RANGE = (0, 6)


def _mini_corpus(root: Path, rirs=RIRS, n_nodes: int = K, mics_per_node: int = C,
                 seconds: float = 2.0):
    """Write a synthetic processed corpus under ``root``: per RIR, a white
    source through a random 8-tap filter per mic plus white noise, the
    target/noise/mixture channel WAVs, the dry target and noise and the SNR
    sidecar, in the layout of ``living/test``.  ``seconds``: clip length
    (scoring skips the first second, the lead silence of real clips)."""
    rng = np.random.default_rng(7)
    layout = DatasetLayout(str(root), "living", "test")
    for rir in rirs:
        L = int(round(seconds * FS))
        src = 0.2 * rng.standard_normal(L)
        for ch in range(1, n_nodes * mics_per_node + 1):
            s = np.convolve(src, rng.standard_normal(8) * 0.5, mode="same")
            n = 0.1 * rng.standard_normal(L)
            write_wav_atomic(layout.wav_processed(SNR_RANGE, "target", rir, ch), s, FS)
            write_wav_atomic(layout.wav_processed(SNR_RANGE, "noise", rir, ch, noise=NOISE), n, FS)
            write_wav_atomic(layout.wav_processed(SNR_RANGE, "mixture", rir, ch, noise=NOISE),
                             s + n, FS)
        write_wav_atomic(layout.dry_source("target", rir, 1), src, FS)
        write_wav_atomic(layout.dry_source("noise", rir, 2, noise=NOISE),
                         0.1 * rng.standard_normal(L), FS)
        save_npy_atomic(layout.snr_log(SNR_RANGE, rir, NOISE), np.full(n_nodes, 3.0))
    return root
