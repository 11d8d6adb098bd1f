"""Threaded loader of magnitude STFTs for the training datasets (counterpart
of ``disco_tpu/nn/fastload.py``).

The JAX package binds a C++ thread pool (``disco_tpu/native/
fastloader.cpp``) and falls back to a NumPy loop; the port keeps the NumPy
arithmetic and runs it on a Python thread pool (``np.load`` and ``np.abs``
release the GIL for the file read and the array work), writing each file's
magnitudes straight into the caller's preallocated float32 buffer.  Nothing
is compiled.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _load_one(path: str, out: np.ndarray, n_freq: int, max_frames: int, skip_cols: int) -> int:
    a = np.abs(np.load(path))[:, skip_cols:]
    if a.shape[0] != n_freq:
        raise RuntimeError(f"fastload: {path}: expected {n_freq} rows, got {a.shape[0]}")
    t = min(a.shape[1], max_frames)
    out[:, :t] = a[:, :t]
    out[:, t:] = 0.0
    return t


def load_abs_batch(paths, n_freq: int, max_frames: int, skip_cols: int = 0,
                   out: np.ndarray | None = None, n_threads: int | None = None):
    """Load |·| of many (n_freq, T) .npy files (complex64 or float32) into
    one (n, n_freq, max_frames) float32 array, zero-padded after each
    file's frames, on ``n_threads`` threads.  Returns (array, n_frames per
    file).

    ``skip_cols`` leading frames of every file are dropped first (the
    reference's first-second silence drop, datasets.py:81).  A file with
    another row count raises RuntimeError naming it; a missing or
    unreadable file raises what ``np.load`` raises; with several bad files
    the first in ``paths`` order is reported — the errors of the JAX
    package's NumPy path.
    """
    paths = [os.fspath(p) for p in paths]
    n = len(paths)
    if out is None:
        out = np.empty((n, n_freq, max_frames), np.float32)
    if out.shape != (n, n_freq, max_frames) or out.dtype != np.float32 \
            or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"fastload: out must be a C-contiguous float32 array of shape "
                         f"{(n, n_freq, max_frames)}, got {out.dtype} {out.shape}")
    if n_threads is None:
        n_threads = min(32, os.cpu_count() or 4)
    frames = np.zeros(n, np.int64)
    if n == 0:
        return out, frames
    with ThreadPoolExecutor(max_workers=max(1, min(n_threads, n)),
                            thread_name_prefix="disco-fastload") as pool:
        futures = [pool.submit(_load_one, p, out[i], n_freq, max_frames, skip_cols)
                   for i, p in enumerate(paths)]
        for i, f in enumerate(futures):
            frames[i] = f.result()
    return out, frames
