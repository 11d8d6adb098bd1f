"""STFT / ISTFT filterbank with librosa-compatible semantics (counterpart
of ``disco_tpu/core/dsp.py``).

Conventions (reference tango.py:28-29,335-337,528-539): n_fft=512,
hop=256, centered reflect padding of n_fft//2 samples, periodic Hann
analysis window, ``1 + (L + 2*(n_fft//2) - n_fft) // hop`` frames, and an
ISTFT that divides the windowed overlap-add by the summed squared window,
trims n_fft//2 samples and cuts or zero-pads to ``length``.

Which route a size takes depends on the size alone:

* :func:`stft` at the kernels' 512/256 is the fused STFT of
  :mod:`disco_tpu_torch.ops.stft_ops` (the hand-written kernel on a CUDA
  tensor, its plain matmul version on a CPU tensor); any other size is
  ``torch.fft.rfft`` of the framed, windowed, reflect-padded rows, the
  reference's own route off the TPU (``_stft_rfft``).
* :func:`istft` at ``n_fft == 2 * hop`` is the ``istft_matmul``
  formulation (two products against the inverse-DFT tables plus the
  50%-overlap chunk add); any other size is ``torch.fft.irfft``, the
  windowed overlap-add by index and the squared-window normalization, as
  the reference's ``_istft_ola``.  Neither is ``torch.istft``, whose NOLA
  check differs from the reference's ``finfo.tiny`` guard.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    (..., n_fft//2 + 1, n_frames): the STFT kernel's route at 512/256,
    :func:`_stft_rfft` at any other size."""
    from disco_tpu_torch.ops.stft_ops import KERNEL_HOP, KERNEL_N_FFT, stft_fused

    if (n_fft, hop) == (KERNEL_N_FFT, KERNEL_HOP):
        return stft_fused(x, n_fft, hop)
    return _stft_rfft(x, n_fft, hop)


def _stft_rfft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered STFT by ``torch.fft.rfft`` of the framed, windowed,
    reflect-padded rows (``disco_tpu/core/dsp.py::_stft_rfft``)."""
    from disco_tpu_torch.ops.stft_ops import _padded_rows

    xp, bs = _padded_rows(x, n_fft)
    frames = xp.unfold(-1, n_fft, hop) * hann_periodic(n_fft, xp.dtype, xp.device)
    spec = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)       # (batch, n_freq, n_frames)
    return spec.reshape(bs + spec.shape[-2:]).to(torch.complex64)


def istft(spec: torch.Tensor, length: int, n_fft: int = N_FFT, hop: int = N_HOP) -> torch.Tensor:
    """Inverse centered STFT (..., n_freq, n_frames) -> float32
    (..., length) by windowed overlap-add with squared-window
    normalization: ``istft_matmul`` at ``n_fft == 2 * hop``,
    :func:`_istft_ola` at any other size."""
    from disco_tpu_torch.ops.stft_ops import istft_matmul

    if n_fft == 2 * hop:
        return istft_matmul(spec, length, n_fft, hop)
    return _istft_ola(spec, length, n_fft, hop)


def _istft_ola(spec: torch.Tensor, length: int, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse centered STFT by ``torch.fft.irfft`` and the windowed
    overlap-add by index (``disco_tpu/core/dsp.py::_istft_ola``)."""
    bs = spec.shape[:-2]
    n_freq, n_frames = spec.shape[-2:]
    if n_freq != n_fft // 2 + 1:
        raise ValueError(f"expected {n_fft // 2 + 1} frequency bins, got {n_freq}")
    frames = torch.fft.irfft(spec.reshape(-1, n_freq, n_frames).transpose(-1, -2), n=n_fft,
                             dim=-1).to(torch.float32)             # (batch, n_frames, n_fft)
    win = hann_periodic(n_fft, frames.dtype, frames.device)
    frames = frames * win
    total = (n_frames - 1) * hop + n_fft
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    y = frames.new_zeros((frames.shape[0], total)).index_add_(1, idx, frames.reshape(
        frames.shape[0], -1))
    wss = frames.new_zeros(total).index_add_(0, idx, (win * win).expand(n_frames, n_fft)
                                             .reshape(-1))
    return ola_finish(y, wss, n_fft // 2, length).reshape(bs + (length,))


def ola_finish(y: torch.Tensor, wss: torch.Tensor, pad: int, length: int) -> torch.Tensor:
    """The overlap-add's last steps, shared by both ISTFT routes: ``y``
    (batch, total) divided by the summed squared window ``wss`` (total,)
    where it exceeds ``finfo.tiny``, trimmed by ``pad`` and cut or
    zero-padded to ``length``."""
    ok = wss > torch.finfo(y.dtype).tiny
    y = torch.where(ok, y / torch.where(ok, wss, torch.ones_like(wss)), y)
    y = y[:, pad: pad + length]
    if y.shape[-1] < length:
        y = F.pad(y, (0, length - y.shape[-1]))
    return y


def bucket_length(length: int, bucket: int = 8192) -> int:
    """A clip length rounded up to a multiple of ``bucket``: the corpus
    driver's length buckets (``disco_tpu/core/dsp.py::bucket_length``).
    Zero-padded frames add zero outer products to both covariances, which
    leaves the GEVD filter unchanged, and ``istft(length=true_length)``
    trims the padded samples; only the last 2-3 analysis frames see zeros
    instead of the reflected tail."""
    return -(-length // bucket) * bucket
