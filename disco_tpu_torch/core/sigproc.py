"""Signal-level helpers: third-octave filterbanks, band-importance weights,
SNR scaling, speech-shaped noise, talker stacking, windowing (the port's
copy of ``disco_tpu/core/sigproc.py``, host numpy).

Capability parity with reference ``disco_theque/sigproc_utils.py``
(third_octave_filterbank:90, fw_snr:120 — the fw_snr itself lives in
``disco_tpu_torch.core.metrics``, increase_to_snr:194, stack_talkers:227,
noise_from_signal:257, third_octave_band:282).  These are host-side corpus /
evaluation utilities; the hot per-sample DSP lives in ``core.dsp`` /
``core.masks``.

The reference's filterbank depends on the ``acoustics`` package's
``OctaveBand`` for band edges; here the edges are the base-2 third-octave
ratios ``fc·2^(±1/6)`` documented in the reference's own ``third_octave_band``
(sigproc_utils.py:282-316) — within 0.04% of acoustics' base-10 convention.
"""
from __future__ import annotations

import numpy as np

from disco_tpu_torch.core.mathx import next_pow_2

__all__ = [
    "third_octave_band",
    "third_octave_filterbank",
    "band_importance",
    "sliding_window",
    "frame_vad",
    "increase_to_snr",
    "noise_from_signal",
    "stack_talkers",
]

# ANSI band-importance weights (Pavlovic 1994), as tabulated in the reference
# (sigproc_utils.py:141-153): (weights*1e4, center frequencies) for wideband
# (fs/2 > 4500 Hz) and narrowband material.
_BIF_WIDE_I = np.array(
    [83, 95, 150, 289, 440, 578, 653, 711, 818, 844, 882, 898, 868, 844, 771, 527, 364, 185]
) * 1e-4
_BIF_WIDE_F = np.array(
    [160, 200, 250, 315, 400, 500, 630, 800, 1000, 1250, 1600, 2000, 2500, 3150, 4000, 5000, 6300, 8000]
)
_BIF_NARROW_I = np.array(
    [128, 320, 320, 447, 447, 639, 639, 767, 959, 1182, 1214, 1086, 1086, 757]
) * 1e-4
_BIF_NARROW_F = np.array(
    [200, 250, 315, 400, 500, 630, 800, 1000, 1250, 1600, 2000, 2500, 3150, 4000]
)


def band_importance(fs):
    """Band-importance weights and third-octave center frequencies kept below
    Nyquist (the band-selection logic of sigproc_utils.py:140-155)."""
    r = 2 ** (1 / 6)
    if fs / 2 > 4500:
        I, F = _BIF_WIDE_I, _BIF_WIDE_F
    else:
        I, F = _BIF_NARROW_I, _BIF_NARROW_F
    n = int(np.sum(F * r < fs / 2))
    return I[:n].copy(), F[:n].copy()


def third_octave_band(ref_freq=1000, i_band=None, n_band=18):
    """Center/lower/upper frequencies of a third-octave bank centered at
    ``ref_freq`` (sigproc_utils.py:282-316): fc = f0·2^(k/3), fl/fu = fc·2^(∓1/6)."""
    if i_band is not None:
        k = i_band
    else:
        k = np.arange(-np.floor((n_band - 1) / 2), np.floor(n_band / 2 + 1))
    fc = 2 ** (np.asarray(k) / 3) * ref_freq
    return fc, fc * 2 ** (-1 / 6), fc * 2 ** (1 / 6)


def third_octave_filterbank(F, fs, order=8):
    """Butterworth bandpass coefficient rows for third-octave bands centered
    at ``F`` (sigproc_utils.py:90-115).  Returns (b, a), each (len(F), 2·order+1)."""
    import scipy.signal

    F = np.asarray(F, np.float64)
    n = len(F)
    b = np.zeros((n, 2 * order + 1))
    a = np.zeros((n, 2 * order + 1))
    for i in range(n):
        lo, hi = F[i] * 2 ** (-1 / 6), F[i] * 2 ** (1 / 6)
        b[i], a[i] = scipy.signal.butter(
            order, np.array([lo, hi]) * 2 / fs, btype="bandpass", output="ba"
        )
    return b, a


def sliding_window(x, win_len, win_hop, axis=-1):
    """Overlapping windows of ``x``: shape (n_win, win_len) for 1-D input.
    (The helper metrics.py:159 imports but the reference never shipped.)"""
    x = np.moveaxis(np.asarray(x), axis, -1)
    n_win = 1 + (x.shape[-1] - win_len) // win_hop
    idx = np.arange(n_win)[:, None] * win_hop + np.arange(win_len)[None, :]
    return x[..., idx]


def frame_vad(vad, win_len, win_hop):
    """Downsample a sample-level VAD to one 0/1 value per analysis window
    (majority vote — the ``db_utils.frame_vad`` the reference imports but
    never shipped, metrics.py:145)."""
    w = sliding_window(np.asarray(vad, np.float64), win_len, win_hop)
    return (np.mean(w, axis=-1) >= 0.5).astype(np.float64)


def increase_to_snr(x, n, snr_out, vad_tar=None, vad_noi=None, weight=False, fs=None):
    """Scale noise ``n`` so SNR(x, n·scale) == ``snr_out`` dB
    (sigproc_utils.py:194-226).  With ``weight=True`` the SNR is the
    frequency-weighted one and scaling is applied in amplitude dB."""
    x = np.asarray(x)
    n = np.asarray(n)
    if weight:
        from disco_tpu_torch.core.metrics import fw_snr

        _, snr_0, _ = fw_snr(x, n, fs, vad_tar=vad_tar, vad_noi=vad_noi)
        return n * 10 ** ((snr_0 - snr_out) / 20)
    var_x = np.var(x[vad_tar != 0]) if vad_tar is not None else np.var(x[x != 0])
    var_n = np.var(n[vad_noi != 0]) if vad_noi is not None else np.var(n[n != 0])
    return n * np.sqrt(10 ** (-snr_out / 10) * var_x / var_n)


def noise_from_signal(x, rng=None):
    """Speech-shaped noise: same magnitude spectrum as ``x``, random phase
    (sigproc_utils.py:257-279).  ``rng`` is an optional np.random.Generator
    for reproducibility (the reference uses the global numpy state)."""
    rng = np.random.default_rng() if rng is None else rng
    x = np.asarray(x)
    n_x = x.shape[-1]
    n_fft = next_pow_2(n_x)
    X = np.fft.rfft(x, next_pow_2(n_fft))
    noise_mag = np.abs(X) * np.exp(2j * np.pi * rng.random(X.shape[-1]))
    return np.real(np.fft.irfft(noise_mag, n_fft))[:n_x]


def stack_talkers(tlk_list, dur_min, speaker, nb_tlk=5, fs=16000, rng=None, read_fn=None):
    """Concatenate ≥``nb_tlk`` random talkers (≠ ``speaker``) until at least
    ``dur_min`` seconds (sigproc_utils.py:227-254).

    ``read_fn(path) -> (signal, fs)`` defaults to
    :func:`disco_tpu_torch.io.read_wav`.
    Returns (signal, fs, newline-joined list of file stems used).
    """
    import os
    import re

    if read_fn is None:
        from disco_tpu_torch.io import read_wav as read_fn
    rng = np.random.default_rng() if rng is None else rng
    i_tlk = 0
    tlk_tot = np.array([])
    str_files = ""
    while len(tlk_tot) < int(dur_min * fs) or i_tlk < nb_tlk:
        pick = int(rng.integers(0, len(tlk_list)))
        spk_tmp = re.split("/", str(tlk_list[pick]))[-1].split("-")[0]
        if spk_tmp != speaker:
            tlk_tmp, fs = read_fn(tlk_list[pick])
            tlk_tot = np.hstack((tlk_tot, tlk_tmp))
            i_tlk += 1
            str_files += os.path.basename(str(tlk_list[pick])).rsplit(".", 1)[0] + "\n"
    return tlk_tot, fs, str_files
