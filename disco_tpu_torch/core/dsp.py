"""STFT / ISTFT filterbank with librosa-compatible semantics (counterpart
of ``disco_tpu/core/dsp.py``).

Conventions (reference tango.py:28-29,335-337,528-539): n_fft=512,
hop=256, centered reflect padding of n_fft//2 samples, periodic Hann
analysis window, ``1 + (L + 2*(n_fft//2) - n_fft) // hop`` frames, and an
ISTFT that divides the windowed overlap-add by the summed squared window,
trims n_fft//2 samples and cuts or zero-pads to ``length``.

:func:`stft` is the fused STFT of :mod:`disco_tpu_torch.ops.stft_ops`
(the hand-written kernel on a CUDA tensor, its plain matmul version on a
CPU tensor).  :func:`istft` is the ``istft_matmul`` formulation (two
products against the inverse-DFT tables plus the 50%-overlap chunk add),
not ``torch.istft``, whose NOLA check differs from the reference's
``finfo.tiny`` guard.
"""
from __future__ import annotations

import math

import torch

N_FFT = 512
N_HOP = 256
N_FREQ = N_FFT // 2 + 1


def hann_periodic(n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic (fftbins=True) Hann window, computed in ``dtype`` like the
    reference's ``0.5 - 0.5 cos(2 pi k / n)``."""
    k = torch.arange(n_fft, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)


def n_stft_frames(length: int, n_fft: int = N_FFT, hop: int = N_HOP) -> int:
    """Number of centered-STFT frames for a signal of ``length`` samples
    (the ``3 + (L - n_fft)//hop`` convention of reference tango.py:287)."""
    return 1 + (length + 2 * (n_fft // 2) - n_fft) // hop


def stft(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP) -> torch.Tensor:
    """Centered STFT of real ``x`` (..., length) -> complex64
    (..., n_fft//2 + 1, n_frames)."""
    from disco_tpu_torch.ops.stft_ops import stft_fused

    return stft_fused(x, n_fft, hop)


def istft(spec: torch.Tensor, length: int, n_fft: int = N_FFT, hop: int = N_HOP) -> torch.Tensor:
    """Inverse centered STFT (..., n_freq, n_frames) -> float32
    (..., length) by windowed overlap-add with squared-window
    normalization."""
    from disco_tpu_torch.ops.stft_ops import istft_matmul

    return istft_matmul(spec, length, n_fft, hop)
