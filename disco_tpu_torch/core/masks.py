"""Ideal time-frequency masks and the oracle VAD (counterpart of
``disco_tpu/core/masks.py``; reference sigproc_utils.py:12-86)."""
from __future__ import annotations

import torch

from disco_tpu_torch.core.mathx import FLOAT64_EPS as _EPS
from disco_tpu_torch.core.mathx import db2lin, quantile_linear


def _from_ratio(xi, family: str, bin_thr: float, dtype):
    if family == "irm":
        return xi / (1.0 + xi)
    return (xi >= float(db2lin(bin_thr))).to(dtype)


def tf_mask(s: torch.Tensor, n: torch.Tensor, mask_type: str = "irm1", bin_thr: float = 0.0):
    """Ideal TF mask from complex target/noise spectrograms: ``'irmX'``
    (ratio), ``'ibmX'`` (binary) or ``'iamX'`` (amplitude), X the power
    applied to the magnitude ratio."""
    power = int(mask_type[-1])
    family = mask_type[:-1]
    if family in ("irm", "ibm"):
        xi = (s.abs() / n.abs().clamp_min(_EPS)) ** power
        return _from_ratio(xi, family, bin_thr, s.real.dtype)
    if family == "iam":
        # eps floor: all-silent bins (|s+n| = 0) must yield 0, not 0/0
        return (s.abs() / (s + n).abs().clamp_min(_EPS)) ** power
    raise ValueError('Unknown mask type. Should be "irmX", "ibmX" or "iamX"')


def tf_mask_mag(mag_s: torch.Tensor, mag_n: torch.Tensor, mask_type: str = "irm1",
                bin_thr: float = 0.0):
    """:func:`tf_mask` from magnitude spectrograms (the consumer of the
    fused STFT's magnitude output); irm/ibm only — the iam family needs the
    complex sum."""
    power = int(mask_type[-1])
    family = mask_type[:-1]
    if family not in ("irm", "ibm"):
        raise ValueError(
            'tf_mask_mag supports "irmX" and "ibmX" (iam needs the complex sum '
            "— use tf_mask)"
        )
    xi = (mag_s / mag_n.clamp_min(_EPS)) ** power
    return _from_ratio(xi, family, bin_thr, mag_s.dtype)


def vad_oracle_batch(x: torch.Tensor, win_len: int = 512, win_hop: int = 256, thr: float = 0.001,
                     rat: int = 2) -> torch.Tensor:
    """Oracle power-threshold VAD (sigproc_utils.py:12-55).

    A window is voice-active when at least ``len(window) // rat`` of its
    samples have instantaneous power above ``thr * q99(power)``; active
    windows paint 1s over the samples they cover (overlapping windows OR
    together).  ``x`` is a waveform (length,); returns a float32 0/1
    vector of the same length, all zeros when the signal is too short for
    a window (the reference evaluates zero windows, sigproc_utils.py:48).
    """
    x = torch.as_tensor(x)
    length = x.shape[-1]
    x2 = ((x - x.mean()) ** 2).abs()
    thr_ = thr * quantile_linear(x2, 0.99)
    n_win = -(-(length - win_len) // win_hop) + 1  # ceil((L - w)/h) + 1
    if n_win <= 0:
        return torch.zeros(length, dtype=torch.float32, device=x.device)
    idx = (torch.arange(n_win, device=x.device)[:, None] * win_hop
           + torch.arange(win_len, device=x.device)[None, :])   # (n_win, win_len)
    valid = idx < length
    idx_c = idx.clamp_max(length - 1)
    above = (x2[idx_c] > thr_) & valid
    active = above.sum(-1) >= valid.sum(-1) // rat  # int(N/rat) of the reference
    contrib = (active[:, None] & valid).to(torch.float32)
    vad = torch.zeros(length, dtype=torch.float32, device=x.device)
    return vad.scatter_reduce(0, idx_c.reshape(-1), contrib.reshape(-1), reduce="amax")


def vad_to_mask(vad: torch.Tensor, n_freq: int, n_frames: int, hop: int = 256) -> torch.Tensor:
    """A sample-level VAD spread across frequencies as an (n_freq, n_frames)
    mask (the 'ivad' branch of reference tango.py:216-221: every ``hop``-th
    sample, tiled over ``n_freq`` rows, trailing frames zero-padded)."""
    v = torch.as_tensor(vad)[::hop]
    v = torch.nn.functional.pad(v, (0, max(0, n_frames - v.shape[0])))[:n_frames]
    return v[None, :].expand(n_freq, n_frames).clone()
