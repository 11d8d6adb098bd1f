"""The yardstick's arithmetic: the card's peaks and the operations and bytes
that each hand-written kernel and each whole batch need, frozen here so that a
later change to the program cannot move them.

Every formula is a copy, with its origin named:

* the peaks: ``disco_tpu_torch/obs/roofline.py`` (NVIDIA's H100 SXM data
  sheet: 67 TFLOP/s float32 outside the tensor cores, 989 dense bf16,
  3.35 TB/s of HBM, at the 700 W limit);
* ``stft_flops``, ``cov_flops``, ``jacobi_flops``, ``mwf_flops``:
  ``disco_tpu_torch/analysis/meter/costmodel.py`` (each kernel op's declared
  operations), with the boundary bytes the meter counts for the same op:
  each input tensor read once and each output written once;
* ``default_sweeps``: ``disco_tpu_torch/ops/eigh_ops.py`` (the sweeps that
  reach float32 residuals), taken as what a pencil needs, whatever sweep
  count a later program passes;
* ``crnn_cost``: ``chip_smoke.py`` (the canonical CRNN's operations from
  its layer shapes).

A roofline share is the least time these counts allow, the larger of
operations over the peak rate and bytes over the peak bandwidth, divided by
the time measured.  Counting only each input once and each output once keeps
the count independent of how the program stores its intermediates.
"""
from __future__ import annotations

import math

#: NVIDIA H100 SXM, dense, at its 700 W limit (``obs/roofline.py``)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

F32, C64 = 4, 8  # bytes of a float32 and of a complex64 element


def bound_s(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """(seconds, 'operations' | 'bytes'): the least time the card needs for
    ``flops`` operations and ``nbytes`` bytes of traffic."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def n_frames(length: int, hop: int = 256) -> int:
    """Frames of the centered STFT of ``length`` samples (n_fft = 2 hop)."""
    return 1 + length // hop


# -- the kernels ---------------------------------------------------------------
def stft_flops(rows: int, length: int, n_fft: int = 512, hop: int = 256,
               with_mag: bool = True) -> int:
    """The STFT kernel (``csrc/stft.cu``): per frame the window, one real FFT
    (2.5 n log2 n) and, with magnitudes, 4 a bin."""
    n_freq = n_fft // 2 + 1
    frames = rows * (1 + length // hop)
    per = n_fft + 2.5 * n_fft * math.log2(n_fft) + (4 * n_freq if with_mag else 0)
    return int(frames * per)


def stft_bytes(rows: int, length: int, n_fft: int = 512, hop: int = 256,
               with_mag: bool = True) -> int:
    """The STFT op's boundary: the float32 rows in, the complex64 spectra and
    (with magnitudes) the float32 magnitudes out."""
    cells = rows * (n_fft // 2 + 1) * (1 + length // hop)
    return rows * length * F32 + cells * (C64 + (F32 if with_mag else 0))


def cov_flops(batch: int, D: int, F: int, T: int, chan: bool) -> int:
    """The masked covariance kernel (``csrc/cov.cu``): per frame and
    upper-triangle pair the complex product and two weighted sums (14),
    per-channel weights 6 more; a shared mask's weights 5 a frame."""
    pairs = D * (D + 1) // 2
    per_t = pairs * (14 + (6 if chan else 0)) + (0 if chan else 5)
    return batch * F * T * per_t


def cov_bytes(batch: int, D: int, F: int, T: int, chan: bool) -> int:
    """The covariance op's boundary: the complex64 streams and the float32
    mask in, both (F, D, D) complex64 covariances out."""
    mask = batch * (D if chan else 1) * F * T * F32
    return batch * D * F * T * C64 + mask + 2 * batch * F * D * D * C64


def default_sweeps(C: int) -> int:
    """Jacobi sweeps that reach float32 residuals on a C x C pencil."""
    if C <= 5:
        return 5
    if C <= 12:
        return 7
    return 8


def jacobi_flops(C: int, sweeps: int) -> int:
    """``sweeps`` cyclic Jacobi sweeps on one C x C Hermitian matrix with V:
    48 C + 20 a rotation."""
    return sweeps * (C * (C - 1) // 2) * (48 * C + 20)


def _chain_flops(C: int) -> int:
    """The fused solve's chain for one pencil without the eigensolve: traces
    and scale, Cholesky, whitening, re-hermitizing, the dominant pair's pick
    and clip, the back-substitution and the filter."""
    f = 3 * C * C + 2 * C + 6
    for j in range(C):
        f += 4 * j + 3 + (C - 1 - j) * (8 * j + 2)
    f += sum(C * (8 * i + 2) for i in range(C))
    f += sum(C * (8 * i + 3) for i in range(C)) + 4 * C * C
    f += C + 2 + sum(8 * (C - 1 - i) + 2 for i in range(C))
    f += 6 + 12 * C
    return f


def mwf_flops(n: int, C: int, sweeps: int | None = None) -> int:
    """The fused rank-1 GEVD-MWF kernel (``csrc/mwf.cu``) on ``n`` pencils."""
    sweeps = default_sweeps(C) if sweeps is None else sweeps
    return n * (_chain_flops(C) + jacobi_flops(C, sweeps))


def mwf_bytes(n: int, C: int, mu_per_pencil: bool = False) -> int:
    """The fused solve's boundary: both (C, C) complex64 pencils in, the
    filter and t1 (C,) complex64 out."""
    return n * (2 * C * C * C64 + 2 * C * C64 + (F32 if mu_per_pencil else 0))


def power_gevd_flops(n: int, C: int, iters: int = 12) -> int:
    """A rank-1 GEVD-MWF by ``iters`` power iterations (the ``'power'``
    solver): the chain above with a complex matrix-vector product and a
    normalization each iteration, and the Rayleigh quotient."""
    return n * (_chain_flops(C) + (iters + 1) * (8 * C * C + 6 * C))


def crnn_cost(n_streams: int, n_ch: int, T: int, win: int = 21, win_out: int = 15) -> float:
    """Operations of one canonical CRNN over ``n_streams`` streams of ``T``
    frames by the stream route: the three 3x3 convs over the padded streams
    (T + win - 1 frames), and per window the GRU's 15 steps (input and
    hidden products, 3 gates of 256) and the 257-wide FF on each of its 15
    frames."""
    flops, t, f, c_in = 0.0, T + win - 1, 257, n_ch
    for c_out in (32, 64, 64):
        t -= 2
        flops += 2 * n_streams * c_out * t * f * c_in * 9
        f, c_in = f // 4, c_out
    steps = n_streams * T * win_out
    return flops + steps * (2 * 3 * 256 * (256 + 256) + 2 * 256 * 257)


def crnn_param_bytes(n_ch: int) -> int:
    """Bytes of one canonical CRNN's float32 weights (read once a forward)."""
    convs = sum(c_out * c_in * 9 + c_out + 4 * c_out
                for c_in, c_out in ((n_ch, 32), (32, 64), (64, 64)))
    gru = 3 * 256 * (256 + 256) + 2 * 3 * 256
    return (convs + gru + 256 * 257 + 257) * F32


# -- the glue a batch needs besides the kernels --------------------------------
def istft_flops(rows: int, T: int, n_fft: int = 512) -> int:
    """An inverse real FFT a frame (2.5 n log2 n), the window and the
    overlap-add (2 a sample of a frame), and the normalization (1 a
    sample)."""
    return int(rows * T * (2.5 * n_fft * math.log2(n_fft) + 3 * n_fft))


def apply_flops(n_out: int, D: int, F: int, T: int) -> int:
    """``n_out`` filtered (F, T) streams, each a D-channel complex dot."""
    return n_out * F * T * 8 * D


# -- a whole batch ---------------------------------------------------------------
def oracle_batch_need(B: int, K: int, C: int, L: int, n_fft: int = 512,
                      hop: int = 256) -> tuple[float, float]:
    """(operations, bytes) the enhanced signals of one batch of B clips need
    with oracle irm masks: the STFT of mixture, speech and noise (the masks
    read the two), the masks, both steps' covariances, solves and the
    filtering that the enhanced signal uses (z_y, then y_f), and the ISTFT;
    the three input stacks read once and the (B, K, L) output written once."""
    F, T = n_fft // 2 + 1, n_frames(L, hop)
    D = C + K - 1
    nodes = B * K
    flops = stft_flops(3 * nodes * C, L, n_fft, hop, with_mag=True)
    flops += nodes * F * T * 4                                        # irm1 masks
    flops += cov_flops(nodes, C, F, T, False) + mwf_flops(nodes * F, C)
    flops += apply_flops(nodes, C, F, T)
    flops += cov_flops(nodes, D, F, T, False) + mwf_flops(nodes * F, D)
    flops += apply_flops(nodes, D, F, T)
    flops += istft_flops(nodes, T, n_fft)
    nbytes = 3 * nodes * C * L * F32 + nodes * L * F32
    return float(flops), float(nbytes)


def crnn_batch_need(B: int, K: int, C: int, L: int, z_iters: int = 12, n_fft: int = 512,
                    hop: int = 256) -> tuple[float, float]:
    """(operations, bytes) the enhanced signals of one batch need with CRNN
    masks: the mixture's STFT, both CRNNs (``crnn_cost``) and their inputs'
    magnitudes, the step 1 that makes the step-2 CRNN's z (power solver),
    both TANGO steps with the fused solve, the filtering the enhanced signal
    uses and the ISTFT; the mixture and both CRNNs' weights read once and the
    (B, K, L) output written once."""
    F, T = n_fft // 2 + 1, n_frames(L, hop)
    D = C + K - 1
    nodes = B * K
    flops = stft_flops(nodes * C, L, n_fft, hop, with_mag=False)
    flops += crnn_cost(nodes, 1, T) + crnn_cost(nodes, K, T)
    flops += nodes * F * T * 3 * (1 + K)                             # |.| of the inputs
    flops += cov_flops(nodes, C, F, T, False) + power_gevd_flops(nodes * F, C, z_iters)
    flops += apply_flops(nodes, C, F, T)
    flops += cov_flops(nodes, C, F, T, False) + mwf_flops(nodes * F, C)
    flops += apply_flops(nodes, C, F, T)
    flops += cov_flops(nodes, D, F, T, False) + mwf_flops(nodes * F, D)
    flops += apply_flops(nodes, D, F, T)
    flops += istft_flops(nodes, T, n_fft)
    nbytes = nodes * C * L * F32 + nodes * L * F32 + crnn_param_bytes(1) + crnn_param_bytes(K)
    return float(flops), float(nbytes)
