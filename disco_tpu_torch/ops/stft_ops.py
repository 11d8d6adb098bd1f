"""The fused STFT (+ magnitude) kernel, its plain version, and the matmul
ISTFT — counterpart of ``disco_tpu/ops/stft_ops.py``.

* :func:`stft_kernel` — the wrapper of the hand-written CUDA kernel
  ``csrc/stft.cu`` (port of ``stft_pallas`` -> ``_stft_kernel``): framing,
  periodic Hann window, the 512x257 cos/sin DFT products and the optional
  magnitude in one launch, written straight into the (B, F, T) complex64
  spec and float32 magnitude planes.  Reflect padding stays here in the
  wrapper.  On a CPU tensor it runs :func:`stft_matmul`.
* :func:`stft_matmul` — the plain version: the framed
  signal times the same DFT tables with ``torch.matmul`` in true float32
  (TF32 is off package-wide).
* :func:`stft_with_mag` / :func:`stft_fused` — the ``impl`` seams of the
  enhancement path (``'auto' | 'xla' | 'pallas'``, ops.resolve routing).
* :func:`istft_matmul` — the inverse as two products against the
  inverse-DFT tables plus the 50%-overlap chunk add (outside any kernel in
  the reference too).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from disco_tpu_torch.core.dsp import N_FFT, N_HOP, hann_periodic
from disco_tpu_torch.ops import _build
from disco_tpu_torch.ops.resolve import check_impl, resolve_precision


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int = N_FFT):
    """(n_fft, n_fft//2+1) cos/sin DFT matrices with exact integer-mod
    angles (float64 host precompute, cast to f32), as numpy."""
    k = np.arange(n_fft // 2 + 1, dtype=np.int64)[:, None]
    n = np.arange(n_fft, dtype=np.int64)[None, :]
    ang = -2.0 * np.pi * ((k * n) % n_fft) / n_fft
    return np.cos(ang).T.astype(np.float32), np.sin(ang).T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def idft_matrices(n_fft: int = N_FFT):
    """(n_fft//2+1, n_fft) inverse-rDFT matrices: ``x = re @ A + im @ B``
    for a conjugate-symmetric spectrum (exact integer-mod angles, float64
    host precompute), as numpy."""
    if n_fft % 2:
        raise ValueError("idft_matrices assumes even n_fft (real Nyquist bin)")
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq, dtype=np.int64)[:, None]
    n = np.arange(n_fft, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((k * n) % n_fft) / n_fft
    # DC and Nyquist count once, middle bins twice (conjugate symmetry)
    w = np.full((n_freq, 1), 2.0)
    w[0] = w[-1] = 1.0
    A = (w * np.cos(ang) / n_fft).astype(np.float32)
    B = (-w * np.sin(ang) / n_fft).astype(np.float32)
    return A, B


@functools.lru_cache(maxsize=8)
def _tables(n_fft: int, device: str):
    """(window, Dre, Dim) on ``device``, contiguous float32."""
    dre, dim = dft_matrices(n_fft)
    return (hann_periodic(n_fft, device=device),
            torch.from_numpy(dre).to(device).contiguous(),
            torch.from_numpy(dim).to(device).contiguous())


def _padded_rows(x: torch.Tensor, n_fft: int):
    """(B, L + n_fft) reflect-padded rows of ``x`` (..., L) and the batch
    shape (the centered-STFT padding)."""
    bs, L = x.shape[:-1], x.shape[-1]
    pad = n_fft // 2
    if L <= pad:
        raise ValueError(f"centered STFT needs more than {pad} samples (reflect padding); got {L}")
    return F.pad(x.reshape(-1, L), (pad, pad), mode="reflect"), bs


def stft_matmul(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP, with_mag: bool = False):
    """The plain version of :func:`stft_kernel`: frames (``unfold`` of the
    reflect-padded rows) times the window, times the DFT tables in float32;
    ``mag = sqrt(re^2 + im^2)`` from the same products."""
    xp, bs = _padded_rows(x, n_fft)
    win, dre, dim = _tables(n_fft, str(x.device))
    wf = xp.unfold(-1, n_fft, hop) * win            # (B, T, n_fft)
    re = torch.matmul(wf, dre).transpose(-1, -2)    # (B, F, T)
    im = torch.matmul(wf, dim).transpose(-1, -2)
    shape = bs + re.shape[-2:]
    spec = torch.complex(re, im).reshape(shape)
    if not with_mag:
        return spec
    return spec, torch.sqrt(re * re + im * im).reshape(shape)


def stft_kernel(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP, with_mag: bool = False):
    """The STFT kernel's wrapper (port of ``stft_pallas``): ``x``
    (..., L) float32 -> spec (..., F, T) complex64 [, mag (..., F, T)].

    A CUDA tensor launches ``csrc/stft.cu`` (and counts the launch in
    ``stft_kernel.launches``); a CPU tensor runs :func:`stft_matmul`.
    """
    if x.device.type == "cpu":
        return stft_matmul(x, n_fft, hop, with_mag)
    _require_cuda_f32(x, "stft_kernel")
    xp, bs = _padded_rows(x, n_fft)
    xp = xp.contiguous()
    B, Lp = xp.shape
    n_freq = n_fft // 2 + 1
    T = 1 + (Lp - n_fft) // hop
    win, dre, dim = _tables(n_fft, str(x.device))
    spec = torch.empty((B, n_freq, T), dtype=torch.complex64, device=x.device)
    mag = torch.empty((B, n_freq, T), dtype=torch.float32, device=x.device) if with_mag else None
    lib = _build.load()
    rc = lib.disco_stft(xp.data_ptr(), win.data_ptr(), dre.data_ptr(), dim.data_ptr(),
                        spec.data_ptr(), None if mag is None else mag.data_ptr(),
                        B, Lp, n_fft, hop, n_freq, T, _build.stream_handle(x.device))
    _build.check(rc, "disco_stft")
    stft_kernel.launches += 1
    spec = spec.reshape(bs + (n_freq, T))
    if not with_mag:
        return spec
    return spec, mag.reshape(bs + (n_freq, T))


stft_kernel.launches = 0


def _require_cuda_f32(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}; expected 'cuda' or 'cpu'")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 signals, got {x.dtype}")


def stft_with_mag(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP,
                  impl: str = "auto", precision: str = "f32"):
    """Fused STFT returning ``(spec, mag)`` for all leading-axis channels in
    one pass — the analysis stage of the enhancement path (the y/s/n
    streams stack on a leading axis and transform together)."""
    resolve_precision(precision)
    check_impl(impl, x, "stft_matmul")
    return stft_kernel(x, n_fft, hop, with_mag=True)


def stft_fused(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP,
               impl: str = "auto", precision: str = "f32") -> torch.Tensor:
    """Spec-only twin of :func:`stft_with_mag`."""
    resolve_precision(precision)
    check_impl(impl, x, "stft_matmul")
    return stft_kernel(x, n_fft, hop)


@functools.lru_cache(maxsize=8)
def _idft_tables(n_fft: int, device: str):
    A, B = idft_matrices(n_fft)
    return torch.from_numpy(A).to(device), torch.from_numpy(B).to(device)


def istft_matmul(spec: torch.Tensor, length: int, n_fft: int = N_FFT, hop: int = N_HOP) -> torch.Tensor:
    """Inverse centered STFT as two products against the inverse-DFT
    tables plus the 50%-overlap chunk add, with squared-window OLA
    normalization (``finfo.tiny`` guard) and the trim/pad to ``length``."""
    if n_fft != 2 * hop:
        raise ValueError("the matmul ISTFT assumes 50% overlap (n_fft == 2*hop)")
    bs = spec.shape[:-2]
    n_freq, n_frames = spec.shape[-2:]
    if n_freq != n_fft // 2 + 1:
        raise ValueError(f"expected {n_fft // 2 + 1} frequency bins, got {n_freq}")
    pad = n_fft // 2
    A, B = _idft_tables(n_fft, str(spec.device))
    sp = spec.reshape(-1, n_freq, n_frames).transpose(-1, -2)  # (B, T, F)
    frames = torch.matmul(sp.real, A) + torch.matmul(sp.imag, B)  # (B, T, n_fft)
    win = hann_periodic(n_fft, device=spec.device)
    frames = frames * win

    # OLA via the chunk trick: output chunk c = frames[c][:hop] + frames[c-1][hop:]
    nb = frames.shape[0]
    y = torch.zeros((nb, n_frames + 1, hop), dtype=frames.dtype, device=frames.device)
    y[:, :n_frames] += frames[..., :hop]
    y[:, 1:] += frames[..., hop:]
    y = y.reshape(nb, (n_frames + 1) * hop)

    w2 = win * win
    wss = torch.zeros((n_frames + 1, hop), dtype=frames.dtype, device=frames.device)
    wss[:n_frames] += w2[:hop]
    wss[1:] += w2[hop:]
    wss = wss.reshape(-1)
    ok = wss > torch.finfo(frames.dtype).tiny
    y = torch.where(ok, y / torch.where(ok, wss, torch.ones_like(wss)), y)

    y = y[:, pad: pad + length]
    if y.shape[-1] < length:
        y = F.pad(y, (0, length - y.shape[-1]))
    return y.reshape(bs + (length,))
