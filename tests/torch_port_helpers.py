"""Shared inputs and measures of the ``disco_tpu_torch`` parity tests.

Every input is made with numpy from a seed and handed, as the same arrays,
to the JAX function and to its port (``device="cpu"``), so a test compares
the two implementations and nothing else.
"""
from __future__ import annotations

import numpy as np
import torch


def to_np(x) -> np.ndarray:
    """A JAX array, tensor or numpy array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over all elements (b is the reference)."""
    a, b = to_np(a).astype(np.complex128), to_np(b).astype(np.complex128)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def max_rel(a, b) -> float:
    """max |a - b| / max |b| (the error against the output scale)."""
    a, b = to_np(a).astype(np.complex128), to_np(b).astype(np.complex128)
    return float(np.abs(a - b).max() / np.abs(b).max())


def complex_normal(rng, shape) -> np.ndarray:
    """complex64 standard normal samples."""
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def pencils(rng, C, F=16, T=80):
    """(F, C, C) float64 Hermitian PSD (Rss, Rnn) pencils: a rank-1
    dominant speech field over diffuse, diagonally loaded noise — the shape
    of the filter bank's covariances."""
    src = rng.standard_normal((F, T))
    gains = rng.standard_normal((C, 1, 1)) + 1j * rng.standard_normal((C, 1, 1))
    S = gains * src[None] + 0.05 * (rng.standard_normal((C, F, T))
                                    + 1j * rng.standard_normal((C, F, T)))
    N = 0.6 * (rng.standard_normal((C, F, T)) + 1j * rng.standard_normal((C, F, T)))
    Rss = np.einsum("cft,dft->fcd", S, np.conj(S)) / T
    Rnn = np.einsum("cft,dft->fcd", N, np.conj(N)) / T + 0.1 * np.eye(C)
    return Rss, Rnn


def scene(K, C, L, seed=0, noise_scale=0.8):
    """(y, s, n), each (K, C, L) float32: a broadband source through short
    random filters per mic plus white noise (the scene of
    ``disco_tpu/milestones.py``)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(L)
    s = np.stack([
        np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same") for _ in range(C)])
        for _ in range(K)
    ]).astype(np.float32)
    n = noise_scale * rng.standard_normal((K, C, L)).astype(np.float32)
    return s + n, s, n
