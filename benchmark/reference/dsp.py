"""The plain STFT and ISTFT that the reference and its control share: the
centered, reflect-padded, periodic-Hann transform of librosa's conventions
(nfurnon/disco ``speech_enhancement/tango.py``: n_fft 512, hop 256), written
as products with the DFT tables so that the control's lower precision reaches
them.  Plain torch in the dtype of the input; nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hann(n_fft: int, dtype, device) -> torch.Tensor:
    """The periodic Hann window ``0.5 - 0.5 cos(2 pi k / n)``."""
    k = torch.arange(n_fft, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)).to(dtype)


def _angles(n_fft: int, device) -> torch.Tensor:
    """(n_fft, n_fft // 2 + 1) angles 2 pi (k n mod N) / N of the real DFT,
    exact in integers before the float64 product."""
    n = torch.arange(n_fft, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(n_fft // 2 + 1, dtype=torch.int64, device=device)[None, :]
    return 2.0 * math.pi * ((n * k) % n_fft).to(torch.float64) / n_fft


def stft(x: torch.Tensor, n_fft: int = 512, hop: int = 256) -> torch.Tensor:
    """(..., L) real -> (..., n_fft // 2 + 1, 1 + L // hop) complex."""
    lead, L = x.shape[:-1], x.shape[-1]
    pad = n_fft // 2
    xp = F.pad(x.reshape(-1, 1, L), (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop) * hann(n_fft, x.dtype, x.device)      # (R, T, n)
    ang = _angles(n_fft, x.device)
    re = frames @ torch.cos(ang).to(x.dtype)
    im = frames @ (-torch.sin(ang)).to(x.dtype)
    spec = torch.complex(re, im).transpose(-1, -2)                            # (R, F, T)
    return spec.reshape(lead + spec.shape[-2:])


def istft(spec: torch.Tensor, length: int, n_fft: int = 512, hop: int = 256) -> torch.Tensor:
    """(..., F, T) complex -> (..., length) real: the inverse real DFT of
    each frame as a product, the windowed overlap-add, the division by the
    summed squared window where it exceeds ``tiny``, the trim of n_fft // 2
    samples and the cut or zero-pad to ``length``."""
    lead, (n_freq, T) = spec.shape[:-2], spec.shape[-2:]
    real = spec.real.dtype
    ang = _angles(n_fft, spec.device).T                                       # (F, n)
    w = torch.full((n_freq, 1), 2.0, dtype=torch.float64, device=spec.device)
    w[0] = w[-1] = 1.0
    A = (w * torch.cos(ang) / n_fft).to(real)
    Bm = (-w * torch.sin(ang) / n_fft).to(real)
    sp = spec.reshape(-1, n_freq, T).transpose(-1, -2)                        # (R, T, F)
    win = hann(n_fft, real, spec.device)
    frames = (sp.real @ A + sp.imag @ Bm) * win                               # (R, T, n)
    total = (T - 1) * hop + n_fft
    y = F.fold(frames.transpose(-1, -2), (1, total), (1, n_fft), stride=(1, hop))[:, 0, 0]
    wss = F.fold((win * win)[None, :, None].expand(1, n_fft, T), (1, total), (1, n_fft),
                 stride=(1, hop))[0, 0, 0]
    ok = wss > torch.finfo(real).tiny
    y = torch.where(ok, y / torch.where(ok, wss, torch.ones_like(wss)), y)
    y = y[:, n_fft // 2: n_fft // 2 + length]
    if y.shape[-1] < length:
        y = F.pad(y, (0, length - y.shape[-1]))
    return y.reshape(lead + (length,))
