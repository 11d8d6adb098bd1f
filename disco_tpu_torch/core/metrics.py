"""Evaluation metrics (the port's copy of ``disco_tpu/core/metrics.py``).

Capability parity with reference ``disco_theque/metrics.py`` (snr:9,
delta_snr:25, sd:46, fw_snr:63, seg_snr:131, reverb_ratios:176, fw_sd:211,
ci_wp:283, si_bss:291, si_sdr:342).  Metrics are *evaluation-time* quantities:
the reference computes them in float64 NumPy (``metrics.py:376-377`` asserts
f64) and SDR parity against it is the acceptance bar, so the canonical
implementations here are host-side float64 NumPy as well, the same code as
the JAX package's.  ``si_sdr_torch`` (the JAX package's ``si_sdr_jax``) is
the batched variant on tensors, on their device.

The reference's ``seg_snr`` is dead code (imports a nonexistent
``sliding_window`` / ``db_utils.frame_vad``, metrics.py:144-145); here the
evident intent is implemented and working (see ``disco_tpu_torch.core.sigproc`` for
the two helpers).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from disco_tpu_torch.core.sigproc import (
    band_importance,
    sliding_window,
    frame_vad,
    third_octave_filterbank,
)

__all__ = [
    "snr",
    "delta_snr",
    "sd",
    "fw_snr",
    "seg_snr",
    "reverb_ratios",
    "fw_sd",
    "ci_wp",
    "si_bss",
    "si_sdr",
    "si_sdr_torch",
]


def _nz_var(x, sel=None):
    """Variance over nonzero samples (or over ``sel != 0``) — the reference's
    convention for ignoring zero-padded segments (metrics.py:21,59)."""
    x = np.asarray(x)
    m = (x != 0) if sel is None else (np.asarray(sel) != 0)
    return np.var(x[m])


def snr(s, n, db=True):
    """Broadband SNR over nonzero segments (metrics.py:9-22)."""
    r = _nz_var(s) / _nz_var(n)
    return 10 * np.log10(r) if db else r


def delta_snr(s_out, n_out, s_in, n_in, db=True):
    """Output-minus-input SNR (metrics.py:25-43)."""
    d = snr(s_out, n_out, True) - snr(s_in, n_in, True)
    return d if db else 10 ** (d / 10)


def sd(s_out, s_in, db=True):
    """Speech distortion var(s_in)/var(s_out) over nonzero segments
    (metrics.py:46-60)."""
    r = _nz_var(s_in) / _nz_var(s_out)
    return 10 * np.log10(r) if db else r


def _fw_banded(a, b_coefs, a_coefs, sel_vad=None):
    """Per-band dB power of ``a`` filtered through each bandpass filter."""
    import scipy.signal

    out = np.zeros(b_coefs.shape[0])
    for i in range(b_coefs.shape[0]):
        f = scipy.signal.lfilter(b_coefs[i], a_coefs[i], a, axis=0)
        out[i] = 10 * np.log10(_nz_var(f, sel=sel_vad if sel_vad is not None else f))
    return out


@functools.lru_cache(maxsize=8)
def _band_design(fs, order=4):
    """Cached (I, F, b, a) band-importance weights + third-octave Butterworth
    coefficients — pure functions of (fs, order), but the scipy filter DESIGN
    (butter → lp2bp_zpk → poly per band) was measured re-running on every
    fw_snr/fw_sd call, ~10% of per-RIR scoring cost.  Arrays are returned
    read-only (shared across calls)."""
    I, F = band_importance(fs)
    b, a = third_octave_filterbank(F, fs, order=order)
    for arr in (I, F, b, a):
        np.asarray(arr).setflags(write=False)
    return I, F, b, a


def fw_snr(s, n, fs, vad_tar=None, vad_noi=None, clipping=1, db=True):
    """Frequency-weighted (band-importance) SNR, ANSI/Pavlovic weights
    (metrics.py:63-128, duplicate sigproc_utils.py:120-190).

    Returns (per-band weighted SNR, scalar mean, center frequencies).
    """
    I, F, b, a = _band_design(fs)
    F = F.copy()  # callers historically received a writable array
    s_p = _fw_banded(s, b, a, vad_tar)
    n_p = _fw_banded(n, b, a, vad_noi)
    snr_var = s_p - n_p
    if clipping:
        snr_var = np.clip(snr_var, -15, 25)
    fqwt = I / np.sum(I) * snr_var
    mean = np.sum(fqwt)
    if not db:
        fqwt, mean = 10 ** (fqwt / 10), 10 ** (mean / 10)
    return fqwt, mean, F


def fw_sd(s_out, s_in, fs, clipping=1, db=True):
    """Frequency-weighted speech distortion (metrics.py:211-279): per-band
    in-minus-out dB power, clipped to [0, 25], band-importance-averaged."""
    I, F, b, a = _band_design(fs)
    F = F.copy()  # callers historically received a writable array
    out_p = _fw_banded(s_out, b, a)
    in_p = _fw_banded(s_in, b, a)
    sd_var = in_p - out_p
    if clipping:
        sd_var = np.clip(sd_var, 0, 25)
    fqwt = I / np.sum(I) * sd_var
    mean = np.sum(fqwt)
    if not db:
        fqwt, mean = 10 ** (fqwt / 10), 10 ** (mean / 10)
    return fqwt, mean, F


def seg_snr(s, n, win_len, win_hop, vad=None, axis=-1):
    """Segmental SNR in dB, VAD-gated, per-window SNR clipped to [-15, 25]
    (working implementation of the intent of metrics.py:131-173)."""
    eps = np.finfo(np.float64).eps
    s = np.asarray(s, np.float64)
    n = np.asarray(n, np.float64)
    if len(s) != len(n):
        pad_s = max(len(n) - len(s), 0)
        pad_n = max(len(s) - len(n), 0)
        s = np.pad(s, (0, pad_s), mode="reflect")
        n = np.pad(n, (0, pad_n), mode="reflect")
    sw = sliding_window(s, win_len, win_hop, axis=axis)
    nw = sliding_window(n, win_len, win_hop, axis=axis)
    sw_var = np.maximum(np.var(sw, axis=-1), eps)
    nw_var = np.maximum(np.var(nw, axis=-1), eps)
    if vad is None:
        batch_vad = np.ones(sw_var.shape)
    else:
        batch_vad = frame_vad(vad, win_len, win_hop)[: sw_var.shape[0]]
    per_win = batch_vad * np.clip(10 * np.log10(sw_var / nw_var), -15, 25)
    return np.sum(per_win) / np.sum(batch_vad)


def reverb_ratios(x, rir, reverb_start=20, fs=16000):
    """Direct-to-reverberant and signal-to-reverberation ratios in dB
    (metrics.py:176-208): split the RIR at ``argmax + reverb_start`` ms."""
    rir = np.asarray(rir)
    i_peak = int(np.argmax(rir))
    n_d = int(1e-3 * reverb_start * fs)
    h_d, h_r = rir[: i_peak + n_d], rir[i_peak + n_d :]
    drr = 10 * np.log10(np.sum(h_d**2) / np.sum(h_r**2))
    x_d = np.convolve(x, h_d)
    x_r = np.convolve(x, h_r)
    srr = 10 * np.log10(np.sum(x_d**2) / np.sum(x_r**2))
    return drr, srr


def ci_wp(x, axis=0):
    """95% normal-approximation confidence half-interval (metrics.py:283-288)."""
    return 1.96 * np.nanstd(x, axis=axis) / np.sqrt(np.shape(x)[axis])


def si_bss(estimated_signal, targets, j, scaling=True):
    """Scale-invariant SDR / SIR / SAR of ``estimated_signal`` against source
    ``j`` of ``targets`` (n_samples, n_src) — Le Roux et al. 2019 decomposition
    (metrics.py:291-339)."""
    targets = np.asarray(targets, np.float64)
    est = np.asarray(estimated_signal, np.float64)
    Rss = targets.T @ targets
    this_s = targets[:, j]
    a = (this_s @ est) / Rss[j, j] if scaling else 1.0
    e_true = a * this_s
    e_res = est - e_true
    Sss = np.sum(e_true**2)
    b = np.linalg.solve(Rss, targets.T @ e_res)
    e_interf = targets @ b
    e_artif = e_res - e_interf
    sisdr = 10 * np.log10(Sss / np.sum(e_res**2))
    sisir = 10 * np.log10(Sss / np.sum(e_interf**2))
    sisar = 10 * np.log10(Sss / np.sum(e_artif**2))
    return sisdr, sisir, sisar


def si_sdr(reference, estimation):
    """Scale-invariant SDR, float64, batched over leading axes
    (metrics.py:342-392; doctest values preserved).

    >>> rng = np.random.RandomState(0)
    >>> ref = rng.randn(100)
    >>> bool(np.isinf(si_sdr(ref, ref)))
    True
    >>> round(float(si_sdr(ref, np.flip(ref))), 12)
    -25.127672346461
    >>> round(float(si_sdr(ref, ref + np.flip(ref))), 12)
    0.481070445786
    >>> round(float(si_sdr(ref, ref + 0.5)), 12)
    6.370460603258
    """
    estimation, reference = np.broadcast_arrays(
        np.asarray(estimation, np.float64), np.asarray(reference, np.float64)
    )
    ref_energy = np.sum(reference**2, axis=-1, keepdims=True)
    alpha = np.sum(reference * estimation, axis=-1, keepdims=True) / ref_energy
    projection = alpha * reference
    noise = estimation - projection
    # A perfect estimate has zero residual: the ratio is +inf by design (see
    # the doctest), so the final divide/log are silenced (this also covers
    # the -inf of a zero projection) — an all-zero reference still warns on
    # the alpha division above.
    with np.errstate(divide="ignore"):
        ratio = np.sum(projection**2, axis=-1) / np.sum(noise**2, axis=-1)
        return 10 * np.log10(ratio)


def si_sdr_torch(reference: torch.Tensor, estimation: torch.Tensor) -> torch.Tensor:
    """SI-SDR on tensors, on their device — same math as :func:`si_sdr`,
    batched over leading axes, in the tensors' precision (the JAX package's
    ``si_sdr_jax``)."""
    ref_energy = torch.sum(reference**2, dim=-1, keepdim=True)
    alpha = torch.sum(reference * estimation, dim=-1, keepdim=True) / ref_energy
    projection = alpha * reference
    noise = estimation - projection
    ratio = torch.sum(projection**2, dim=-1) / torch.sum(noise**2, dim=-1)
    return 10.0 * torch.log10(ratio)


# --------------------------------------------------------------------- STOI
# The reference evaluates intelligibility with pystoi (tango.py:569-578).
# pystoi is a CPython/NumPy package; here the algorithm (Taal et al., "An
# Algorithm for Intelligibility Prediction of Time-Frequency Weighted Noisy
# Speech", IEEE TASLP 2011) is implemented natively so the framework owns
# the capability without the undeclared dependency.

_STOI_FS = 10000  # internal rate
_STOI_NFFT = 512
_STOI_WIN = 256
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_SEG = 30  # analysis segment: 30 frames = 384 ms
_STOI_BETA = -15.0  # clipping SDR bound, dB
_STOI_DYN = 40.0  # silent-frame energy range, dB


def _stoi_third_octaves(fs=_STOI_FS, nfft=_STOI_NFFT, n_bands=_STOI_NBANDS, min_freq=_STOI_MINFREQ):
    """Rectangular one-third-octave band matrix (n_bands, nfft//2+1)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(n_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((n_bands, len(f)))
    for i in range(n_bands):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm


def _stoi_frames(x, win=_STOI_WIN, hop=_STOI_HOP):
    if len(x) < win:  # shorter than one frame: no frames (stoi -> nan)
        return np.zeros((0, win))
    n = 1 + (len(x) - win) // hop
    idx = np.arange(win)[None, :] + hop * np.arange(n)[:, None]
    return x[idx] * np.hanning(win + 2)[1:-1]


def _remove_silent_frames(x, y, dyn_range=_STOI_DYN, win=_STOI_WIN, hop=_STOI_HOP):
    """Drop frames of x whose energy is > dyn_range dB below the loudest
    frame; apply the same selection to y; overlap-add back to time."""
    xf, yf = _stoi_frames(x, win, hop), _stoi_frames(y, win, hop)
    if not len(xf):
        return np.zeros(0), np.zeros(0)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + np.finfo(np.float64).eps)
    keep = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[keep], yf[keep]
    n_kept = xf.shape[0]
    out_len = (n_kept - 1) * hop + win if n_kept else 0
    # vectorized overlap-add: scatter every (frame, tap) into its output
    # position in one ufunc pass (the per-frame Python loop was a measured
    # corpus-scoring hot spot)
    idx = (hop * np.arange(n_kept)[:, None] + np.arange(win)[None, :]).ravel()
    w = np.hanning(win + 2)[1:-1]
    xs, ys, wsum = np.zeros(out_len), np.zeros(out_len), np.zeros(out_len)
    np.add.at(xs, idx, xf.ravel())
    np.add.at(ys, idx, yf.ravel())
    np.add.at(wsum, idx, np.broadcast_to(w, (n_kept, win)).ravel())
    wsum[wsum == 0] = 1.0
    return xs / wsum, ys / wsum


def _resample_to_10k(x, fs):
    from scipy.signal import resample_poly

    if fs == _STOI_FS:
        return np.asarray(x, np.float64)
    g = np.gcd(int(fs), _STOI_FS)
    return resample_poly(np.asarray(x, np.float64), _STOI_FS // g, int(fs) // g)


def stoi(x, y, fs_sig, extended: bool = False):
    """Short-Time Objective Intelligibility of degraded signal ``y`` against
    clean ``x`` (Taal et al. 2011), in [~0, 1].  Drop-in for
    ``pystoi.stoi`` as the reference uses it (tango.py:569-574)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    assert x.shape == y.shape, "x and y must have the same length"
    x, y = _resample_to_10k(x, fs_sig), _resample_to_10k(y, fs_sig)
    x, y = _remove_silent_frames(x, y)
    if len(x) < _STOI_WIN:
        return np.nan

    xf, yf = _stoi_frames(x), _stoi_frames(y)
    X = np.fft.rfft(xf, _STOI_NFFT, axis=1)
    Y = np.fft.rfft(yf, _STOI_NFFT, axis=1)
    obm = _stoi_third_octaves()
    # (frames, bands) band magnitudes
    Xb = np.sqrt(np.maximum(np.abs(X) ** 2 @ obm.T, 0.0)).T
    Yb = np.sqrt(np.maximum(np.abs(Y) ** 2 @ obm.T, 0.0)).T
    n_frames = Xb.shape[1]
    if n_frames < _STOI_SEG:
        return np.nan

    eps = np.finfo(np.float64).eps
    if extended:
        d_sum, n_seg = 0.0, 0
        for m in range(_STOI_SEG, n_frames + 1):
            Xs = Xb[:, m - _STOI_SEG : m]
            Ys = Yb[:, m - _STOI_SEG : m]
            Xs = (Xs - Xs.mean(axis=1, keepdims=True)) / (np.linalg.norm(Xs - Xs.mean(axis=1, keepdims=True), axis=1, keepdims=True) + eps)
            Ys = (Ys - Ys.mean(axis=1, keepdims=True)) / (np.linalg.norm(Ys - Ys.mean(axis=1, keepdims=True), axis=1, keepdims=True) + eps)
            Xs = (Xs - Xs.mean(axis=0, keepdims=True)) / (np.linalg.norm(Xs - Xs.mean(axis=0, keepdims=True), axis=0, keepdims=True) + eps)
            Ys = (Ys - Ys.mean(axis=0, keepdims=True)) / (np.linalg.norm(Ys - Ys.mean(axis=0, keepdims=True), axis=0, keepdims=True) + eps)
            d_sum += np.sum(Xs * Ys) / _STOI_SEG
            n_seg += 1
        return d_sum / n_seg

    d_sum, n_seg = _stoi_corr_sum(Xb, Yb)
    return d_sum / (n_seg * _STOI_NBANDS)


def _stoi_corr_sum(Xb, Yb):
    """Sum over sliding 30-frame segments of the per-band clipped envelope
    correlations (the inner loop of Taal et al. 2011, eqs. 4-6), given the
    (bands, frames) third-octave envelope matrices.

    Factored out so the correlation machinery can be anchored analytically
    on hand-built envelopes (tests/test_analytic_anchors.py) independent of
    the framing/FFT front end.  Returns (d_sum, n_segments)."""
    eps = np.finfo(np.float64).eps
    n_frames = Xb.shape[1]
    beta_clip = 10.0 ** (-_STOI_BETA / 20.0)
    d_sum, n_seg = 0.0, 0
    for m in range(_STOI_SEG, n_frames + 1):
        Xs = Xb[:, m - _STOI_SEG : m]
        Ys = Yb[:, m - _STOI_SEG : m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (np.linalg.norm(Ys, axis=1, keepdims=True) + eps)
        Yp = np.minimum(Ys * alpha, Xs * (1.0 + beta_clip))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Yp - Yp.mean(axis=1, keepdims=True)
        corr = np.sum(xm * ym, axis=1) / (np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + eps)
        d_sum += corr.sum()
        n_seg += 1
    return d_sum, n_seg
