"""BSS-eval source-separation metrics (Vincent, Gribonval & Fevotte, "Performance
measurement in blind audio source separation", IEEE TASLP 2006) — the port's
copy of ``disco_tpu/core/bss.py``, numpy and scipy in float64.

The reference scores enhancement with mir_eval's ``bss_eval_sources``
(reference tango.py:552-567), which admits a ``filt_len``-tap (512 by
convention) time-invariant FIR filtering of each reference source as
allowed distortion.  The scale-invariant family (``core.metrics.si_bss``,
Le Roux et al. 2019) admits only a scalar gain, so the two families are
*different metrics*: paper-table comparability (TASLP 2021) requires this
filtered-projection variant.  mir_eval is an undeclared dependency of the
reference and is not bundled here; the algorithm is implemented natively
from the published decomposition (the JAX package's copy is pinned
against an independent brute-force least-squares oracle; this one is held
to it by tests/test_torch_port_metrics.py).

Definitions, for estimate e and references s_1..s_n (all length ``T``),
with P_W the orthogonal projection onto span{s_i delayed by 0..L-1 : i in W}:

    s_target = P_{j}(e)                 (target + admissible filtering)
    e_interf = P_{all}(e) - P_{j}(e)    (other-source leakage)
    e_artif  = e - P_{all}(e)           (everything else)

    SDR = 10 log10 ||s_target||^2 / ||e_interf + e_artif||^2
    SIR = 10 log10 ||s_target||^2 / ||e_interf||^2
    SAR = 10 log10 ||s_target + e_interf||^2 / ||e_artif||^2

All math is host-side float64, like every evaluation-time metric in this
package (the reference asserts f64 in metrics.py:376-377).
"""
from __future__ import annotations

import itertools

import numpy as np
import scipy.linalg
import scipy.signal

__all__ = ["bss_eval_sources", "bss_eval_one", "BssEval", "DEFAULT_FILT_LEN"]

DEFAULT_FILT_LEN = 512  # mir_eval's convention, used by the reference


def _gram(c, srcs, flen):
    """Assemble the block-Toeplitz Gram matrix over the given source subset:
    block (i, j) has entry [tau, tau'] = c[i, j, tau' - tau]."""
    n = len(srcs)
    G = np.empty((n * flen, n * flen))
    for a, i in enumerate(srcs):
        for b, j in enumerate(srcs):
            # Block entry [tau, tau'] = c_ij(tau - tau'); first column is
            # c_ij(tau), first row is c_ij(-tau') = c_ji(tau').
            col = c[i, j, :flen]
            row = c[j, i, :flen]
            G[a * flen : (a + 1) * flen, b * flen : (b + 1) * flen] = scipy.linalg.toeplitz(col, row)
    return G


def _factor_gram(G):
    """Factor the (SPD up to rank deficiency) Gram once: a Cholesky factor
    when it exists, plus the raw matrix for the lstsq fallback (silent or
    colinear references)."""
    try:
        return (scipy.linalg.cho_factor(G), G)
    except (np.linalg.LinAlgError, scipy.linalg.LinAlgError):
        return (None, G)


def _solve_coeffs(factor, d_cat):
    cho, G = factor
    if cho is not None:
        coef = scipy.linalg.cho_solve(cho, d_cat)
        if np.all(np.isfinite(coef)):
            return coef
    return np.linalg.lstsq(G, d_cat, rcond=None)[0]


class _Projector:
    """Least-squares FIR projector onto delayed spans of a fixed reference
    set.  Grams (full set and each single source) are built and factored
    once, then reused for every estimated source — the expensive part is
    per-reference-set, not per-estimate."""

    def __init__(self, refs, flen):
        self.refs = refs
        self.flen = flen
        self.nsrc, self.T = refs.shape
        self._n_fft = 1 << int(self.T + flen - 1).bit_length()
        self._R = np.fft.rfft(refs, self._n_fft, axis=1)
        # c[i, j, k] = sum_u refs[i, u] * refs[j, u + k], k stored mod n_fft
        self._c = np.fft.irfft(np.conj(self._R)[:, None, :] * self._R[None, :, :], self._n_fft, axis=-1)
        self._G = {}

    def project(self, est, srcs):
        """Projection of ``est`` onto span{refs[i] delayed 0..flen-1 : i in
        srcs}, returned with length T + flen - 1."""
        flen = self.flen
        # d[i, k] = sum_u refs[i, u] * est[u + k], k = 0..flen-1
        E = np.fft.rfft(est, self._n_fft)
        d = np.fft.irfft(np.conj(self._R) * E[None, :], self._n_fft, axis=-1)[:, :flen]
        key = tuple(srcs)
        if key not in self._G:
            self._G[key] = _factor_gram(_gram(self._c, srcs, flen))
        d_cat = np.concatenate([d[i] for i in srcs])
        coef = _solve_coeffs(self._G[key], d_cat).reshape(len(srcs), flen)
        proj = np.zeros(self.T + flen - 1)
        for a, i in enumerate(srcs):
            proj += scipy.signal.fftconvolve(self.refs[i], coef[a])[: self.T + flen - 1]
        return proj


def _safe_db(num, den):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(10 * np.log10(num / den))


def _decompose(proj: _Projector, est, j):
    """(SDR, SIR, SAR) of ``est`` as an estimate of source ``j``."""
    flen, T = proj.flen, proj.T
    s_target = proj.project(est, [j])
    p_all = proj.project(est, list(range(proj.nsrc)))
    e_interf = p_all - s_target
    e_artif = -p_all
    e_artif[:T] += est
    sdr = _safe_db(np.sum(s_target**2), np.sum((e_interf + e_artif) ** 2))
    sir = _safe_db(np.sum(s_target**2), np.sum(e_interf**2))
    sar = _safe_db(np.sum((s_target + e_interf) ** 2), np.sum(e_artif**2))
    return sdr, sir, sar


class BssEval:
    """Reusable scorer: several estimates against ONE reference set.

    The Gram build + factorization is per-reference-set (the expensive part
    for 512 taps: a (nsrc*512)^2 block-Toeplitz solve); each ``score`` then
    costs one FFT correlation and two triangular solves.  Use this instead
    of repeated :func:`bss_eval_one` when scoring in/out/mid estimates
    against the same references, as the enhancement driver does."""

    def __init__(self, reference_sources, filt_len: int = DEFAULT_FILT_LEN):
        refs = np.atleast_2d(np.asarray(reference_sources, np.float64))
        self._proj = _Projector(refs, filt_len)

    def score(self, estimate, j: int = 0):
        """(SDR, SIR, SAR) of ``estimate`` as an estimate of source ``j``."""
        return _decompose(self._proj, np.asarray(estimate, np.float64), j)


def bss_eval_one(reference_sources, estimate, j: int = 0, filt_len: int = DEFAULT_FILT_LEN):
    """(SDR, SIR, SAR) of a single ``estimate`` against reference source
    ``j`` — the one entry the reference keeps from each of its
    ``bss_eval_sources(..., compute_permutation=False)[...][0]`` calls
    (tango.py:551-567), without paying for the discarded rows."""
    return BssEval(reference_sources, filt_len).score(estimate, j)


def bss_eval_sources(reference_sources, estimated_sources, compute_permutation: bool = True,
                     filt_len: int = DEFAULT_FILT_LEN):
    """SDR / SIR / SAR with ``filt_len``-tap filtered-reference projection —
    the metric family of mir_eval's ``bss_eval_sources`` as the reference
    uses it (tango.py:552-567, ``bss(refs, ests, compute_permutation=False)``).

    Args:
      reference_sources: (nsrc, nsampl) true sources.
      estimated_sources: (nsrc, nsampl) estimates.
      compute_permutation: when True, try every source permutation and keep
        the one with the best mean SIR (mir_eval semantics); when False,
        score estimate i against reference i.
      filt_len: admissible distortion filter length in taps.

    Returns:
      (sdr, sir, sar, perm): float64 arrays of shape (nsrc,); ``perm[i]`` is
      the reference index scored against estimate i.
    """
    refs = np.atleast_2d(np.asarray(reference_sources, np.float64))
    ests = np.atleast_2d(np.asarray(estimated_sources, np.float64))
    assert refs.shape == ests.shape, (refs.shape, ests.shape)
    nsrc = refs.shape[0]
    proj = _Projector(refs, filt_len)

    if not compute_permutation:
        vals = np.array([_decompose(proj, ests[i], i) for i in range(nsrc)])
        return vals[:, 0], vals[:, 1], vals[:, 2], np.arange(nsrc)

    table = np.full((nsrc, nsrc, 3), np.nan)
    for i in range(nsrc):
        for j in range(nsrc):
            table[i, j] = _decompose(proj, ests[i], j)
    best, best_sir = tuple(range(nsrc)), -np.inf
    for perm in itertools.permutations(range(nsrc)):
        mean_sir = np.mean([table[i, perm[i], 1] for i in range(nsrc)])
        # NaN SIRs (e.g. an all-zero estimate) never beat best_sir, so the
        # identity initialization keeps the degenerate case well-defined.
        if mean_sir > best_sir:
            best, best_sir = perm, mean_sir
    perm = np.array(best)
    picked = np.array([table[i, perm[i]] for i in range(nsrc)])
    return picked[:, 0], picked[:, 1], picked[:, 2], perm
