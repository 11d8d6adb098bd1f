"""Batched WAV reading for the corpus driver (counterpart of
``disco_tpu/io/fastwav.py::read_wavs_batch``).

The JAX package decodes a clip's ~48 channel files with a native threaded
reader it compiles from ``disco_tpu/native/``; the port builds nothing but
its CUDA kernels, so here the same batch is a thread pool over
:func:`~disco_tpu_torch.io.audio.read_wav` (file reads and numpy's decode
release the GIL).  The result is the same: one (n, L) float32 array and the
sample rate, with the same per-file checks.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from disco_tpu_torch.io.audio import read_wav


def _read_mono(path):
    x, fs = read_wav(path)
    if x.ndim != 1:
        raise RuntimeError(f"fastwav: {path!r} is not mono")
    return x, fs


def read_wavs_batch(paths, n_threads: int | None = None):
    """Decode many equal-length mono wavs into one (n, L) float32 array.

    Returns (signals, fs).  All files must be mono, the same length and the
    same sample rate — the corpus per-RIR contract; a RuntimeError names
    the offending file otherwise.  ``n_threads``: reader threads (default
    ``min(32, cpu_count)``).
    """
    paths = [os.fspath(p) for p in paths]
    if not paths:
        raise ValueError("read_wavs_batch: empty path list")
    if n_threads is None:
        n_threads = min(32, os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=max(1, min(n_threads, len(paths)))) as ex:
        decoded = list(ex.map(_read_mono, paths))
    L, fs0 = len(decoded[0][0]), decoded[0][1]
    for p, (x, fs) in zip(paths, decoded):
        if len(x) != L:
            raise RuntimeError(
                f"fastwav: ragged batch — {p!r} has {len(x)} samples, expected {L}"
            )
        if fs != fs0:
            raise RuntimeError(f"fastwav: mixed sample rates — {p!r} at {fs} Hz, expected {fs0}")
    out = np.empty((len(paths), L), np.float32)
    for i, (x, _) in enumerate(decoded):
        out[i] = x
    return out, fs0
