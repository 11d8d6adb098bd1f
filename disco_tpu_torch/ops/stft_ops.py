"""The fused STFT (+ magnitude) kernels, their plain version, and the
matmul ISTFT — counterpart of ``disco_tpu/ops/stft_ops.py``.

* :func:`stft_kernel` — the wrapper of the hand-written CUDA kernel
  ``csrc/stft.cu`` (port of ``stft_pallas`` -> ``_stft_kernel``, f32
  lane): reflect padding, framing, periodic Hann window, one 512-point
  real FFT per frame (from the twiddle tables of :func:`rfft_tables`) and
  the optional magnitude in one launch, written straight into the
  (B, F, T) complex64 spec and float32 magnitude planes.  On a CPU tensor
  it runs :func:`stft_matmul`.
* :func:`stft_bf16_kernel` — the wrapper of ``csrc/stft_bf16.cu``, the
  same kernel's bf16 lane: a DFT product on the tensor cores (bf16 frames
  and tables, float32 accumulators; the real FFT has no bf16 form), fed
  the tables in its ``wgmma`` operand layout and chunk order
  (:func:`dft_fragments`; bin 256 from :func:`nyquist_table` on the CUDA
  cores).  On a CPU tensor it runs
  ``stft_matmul(..., precision='bf16')``.
* :func:`stft_matmul` — the plain version: the same function, the framed
  signal times the DFT tables of :func:`dft_matrices` with ``torch.matmul``
  in true float32 (TF32 is off package-wide), as the TPU kernel computes
  it; under ``precision='bf16'`` the windowed frames and the tables are
  rounded to bf16 first (``ops/resolve.py``'s rounding points).  It is the
  kernels' yardstick, not a copy of the FFT's steps; those are held by a
  numpy model of the kernel on its own tables
  (``tests/test_torch_port_fft.py``).
* :func:`stft_with_mag` / :func:`stft_fused` — the ``impl`` and
  ``precision`` seams of the enhancement path (``'auto' | 'xla' |
  'pallas'``, ops.resolve routing).
* :func:`istft_matmul` — the inverse as two products against the
  inverse-DFT tables plus the 50%-overlap chunk add (outside any kernel in
  the reference too).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from disco_tpu_torch.core.dsp import N_FFT, N_HOP, hann_periodic, ola_finish
from disco_tpu_torch.device import device_cache
from disco_tpu_torch.ops import _build
from disco_tpu_torch.ops.resolve import bf16_round, check_impl, resolve_precision

#: the one (n_fft, hop) the CUDA kernel computes (its FFT is 512 = 2 x 16 x 16)
KERNEL_N_FFT, KERNEL_HOP = 512, 256


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int = N_FFT):
    """(n_fft, n_fft//2+1) cos/sin DFT matrices with exact integer-mod
    angles (float64 host precompute, cast to f32), as numpy."""
    k = np.arange(n_fft // 2 + 1, dtype=np.int64)[:, None]
    n = np.arange(n_fft, dtype=np.int64)[None, :]
    ang = -2.0 * np.pi * ((k * n) % n_fft) / n_fft
    return np.cos(ang).T.astype(np.float32), np.sin(ang).T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def rfft_tables(n_fft: int = N_FFT):
    """The FFT kernel's twiddle tables as complex64 numpy, float64 host
    precompute from exact integer-mod angles, cast to float32:
    ``tw[k] = e^{-2 pi i k / M}``, k < M = n_fft // 2 (the M-point complex
    FFT of the packed frame; ``tw[16 j]`` are its 16-point stages' twiddles),
    and ``post[k] = e^{-2 pi i k / n_fft}``, k <= M (the split post-pass to
    the n_fft // 2 + 1 bins)."""
    m = n_fft // 2
    ang = -2.0 * np.pi * (np.arange(m, dtype=np.int64) % m) / m
    tw = np.cos(ang) + 1j * np.sin(ang)
    ang = -2.0 * np.pi * (np.arange(m + 1, dtype=np.int64) % n_fft) / n_fft
    post = np.cos(ang) + 1j * np.sin(ang)
    return tw.astype(np.complex64), post.astype(np.complex64)


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


@device_cache()
def _tables(n_fft: int, device: str, precision: str = "f32"):
    """(window, Dre, Dim) on ``device``, contiguous float32; the tables
    rounded to bf16 under ``precision='bf16'``."""
    dre, dim = (torch.from_numpy(d) for d in dft_matrices(n_fft))
    if precision == "bf16":
        dre, dim = bf16_round(dre), bf16_round(dim)
    return (hann_periodic(n_fft, device=device), dre.to(device).contiguous(),
            dim.to(device).contiguous())


#: ``csrc/stft_bf16.cu``'s geometry: bin groups of 8 a slab, table chunks of
#: 32 samples; the frame samples chunk c covers start at ``chunk_starts()[c]``
BF16_SLAB_GROUPS, BF16_CHUNK = 8, 32


def chunk_starts(n_fft: int = N_FFT) -> np.ndarray:
    """The first frame sample of each table chunk of ``csrc/stft_bf16.cu``,
    in the order the kernel consumes them: phase p (p = 0 .. 7) holds frame
    samples 32 p .. 32 p + 31 (its LO rows, chunk 2 p) and 256 + 32 p ..
    256 + 32 p + 31 (its HI rows, chunk 2 p + 1)."""
    c = np.arange(n_fft // BF16_CHUNK)
    return (n_fft // 2) * (c & 1) + BF16_CHUNK * (c >> 1)


@device_cache()
def dft_fragments(n_fft: int = N_FFT, device: str = "cpu") -> torch.Tensor:
    """The bf16 DFT tables of bins 0 .. n_fft/2 - 1 in the order
    ``csrc/stft_bf16.cu`` copies them into its shared-memory ring, each
    chunk a ``wgmma`` B operand in the no-swizzle core-matrix layout:
    (S, n_fft / 32, 16, 4, 8, 8) bf16 for S slabs of 64 bins.  Slab s,
    chunk c (frame samples ``chunk_starts()[c]`` + 0 .. 31), column group
    j (the cos table of bin group 8 s + j // 2 for even j, its sin table for
    odd j), sample group kg, row r and sample kk hold the table at sample
    n0 + 8 kg + kk of bin 8 (8 s + j // 2) + r: an 8 x 8 core matrix of 128
    contiguous bytes, core matrices 128 bytes apart along the samples and
    512 along the columns.  Bin n_fft/2 is :func:`nyquist_table`'s."""
    _, dre, dim = _tables(n_fft, "cpu", "bf16")
    bins = n_fft // 2
    slabs = bins // (8 * BF16_SLAB_GROUPS)
    tab = torch.stack([d[:, :bins] for d in (dre, dim)])                 # (2, n, bins)
    tab = tab.reshape(2, n_fft, slabs, BF16_SLAB_GROUPS, 8)              # (c, n, s, group, r)
    tab = tab.permute(2, 3, 0, 1, 4).reshape(slabs, 2 * BF16_SLAB_GROUPS, n_fft, 8)
    n0 = torch.from_numpy(chunk_starts(n_fft))
    idx = n0[:, None, None] + 8 * torch.arange(BF16_CHUNK // 8)[None, :, None] \
        + torch.arange(8)[None, None, :]                                   # (c, kg, kk)
    frag = tab[:, :, idx, :]                                     # (s, j, c, kg, kk, r)
    frag = frag.permute(0, 2, 1, 3, 5, 4)                         # (s, c, j, kg, r, kk)
    return frag.to(torch.bfloat16).contiguous().to(device)


@device_cache()
def nyquist_table(n_fft: int = N_FFT, device: str = "cpu") -> torch.Tensor:
    """(2, n_fft) float32: the bf16 cos and sin tables of bin n_fft/2, which
    ``csrc/stft_bf16.cu`` sums on the CUDA cores."""
    _, dre, dim = _tables(n_fft, "cpu", "bf16")
    return torch.stack([dre[:, -1], dim[:, -1]]).contiguous().to(device)


@device_cache()
def _fft_tables(n_fft: int, device: str):
    """(window, tw, post) on ``device``: what the kernel is handed."""
    tw, post = rfft_tables(n_fft)
    return (hann_periodic(n_fft, device=device), torch.from_numpy(tw).to(device),
            torch.from_numpy(post).to(device))


def _padded_rows(x: torch.Tensor, n_fft: int):
    """(B, L + n_fft) reflect-padded rows of ``x`` (..., L) and the batch
    shape (the centered-STFT padding)."""
    bs, L = x.shape[:-1], x.shape[-1]
    pad = n_fft // 2
    if L <= pad:
        raise ValueError(f"centered STFT needs more than {pad} samples (reflect padding); got {L}")
    return F.pad(x.reshape(-1, L), (pad, pad), mode="reflect"), bs


def stft_matmul(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP, with_mag: bool = False,
                precision: str = "f32"):
    """The plain version of :func:`stft_kernel` and, under
    ``precision='bf16'``, of :func:`stft_bf16_kernel`: frames (``unfold`` of
    the reflect-padded rows) times the window, times the DFT tables in
    float32; ``mag = sqrt(re^2 + im^2)`` from the same products.  The bf16
    lane rounds the windowed frames and the tables to bf16 first."""
    precision = resolve_precision(precision)
    xp, bs = _padded_rows(x, n_fft)
    win, dre, dim = _tables(n_fft, str(x.device), precision)
    wf = xp.unfold(-1, n_fft, hop) * win            # (B, T, n_fft)
    if precision == "bf16":
        wf = bf16_round(wf)
    re = torch.matmul(wf, dre).transpose(-1, -2)    # (B, F, T)
    im = torch.matmul(wf, dim).transpose(-1, -2)
    shape = bs + re.shape[-2:]
    spec = torch.complex(re, im).reshape(shape)
    if not with_mag:
        return spec
    return spec, torch.sqrt(re * re + im * im).reshape(shape)


def _check_kernel_input(x: torch.Tensor, n_fft: int, hop: int, name: str) -> None:
    """The checks of both STFT kernels' wrappers: raise unless ``x`` is a
    float32 CUDA tensor of more than n_fft/2 samples and the size is the
    kernels' 512/256."""
    _require_cuda_f32(x, name)
    if (n_fft, hop) != (KERNEL_N_FFT, KERNEL_HOP):
        raise ValueError(f"{name}: the kernel computes the {KERNEL_N_FFT}/{KERNEL_HOP} "
                         f"STFT; got n_fft={n_fft}, hop={hop}")
    if x.shape[-1] <= n_fft // 2:
        raise ValueError(f"centered STFT needs more than {n_fft // 2} samples "
                         f"(reflect padding); got {x.shape[-1]}")


def _stft_launch(x: torch.Tensor, n_fft: int, hop: int, with_mag: bool, bf16: bool) -> list:
    """One launch of ``csrc/stft.cu`` (``csrc/stft_bf16.cu`` under ``bf16``)
    on a CUDA tensor the wrapper has checked (:func:`_check_kernel_input`):
    [spec] or [spec, mag]."""
    bs, L = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, L).contiguous()
    B, n_freq, T = rows.shape[0], n_fft // 2 + 1, 1 + L // hop
    spec = torch.empty((B, n_freq, T), dtype=torch.complex64, device=x.device)
    mag = torch.empty((B, n_freq, T), dtype=torch.float32, device=x.device) if with_mag else None
    lib = _build.load()
    if bf16:
        win = hann_periodic(n_fft, device=x.device)
        rc = lib.disco_stft_bf16(rows.data_ptr(), win.data_ptr(),
                                 dft_fragments(n_fft, str(x.device)).data_ptr(),
                                 nyquist_table(n_fft, str(x.device)).data_ptr(), spec.data_ptr(),
                                 None if mag is None else mag.data_ptr(), B, L, n_fft, hop, T,
                                 _build.stream_handle(x.device))
        _build.check(rc, "disco_stft_bf16")
        stft_bf16_kernel.launches += 1
    else:
        win, tw, post = _fft_tables(n_fft, str(x.device))
        rc = lib.disco_stft(rows.data_ptr(), win.data_ptr(), tw.data_ptr(), post.data_ptr(),
                            spec.data_ptr(), None if mag is None else mag.data_ptr(),
                            B, L, n_fft, hop, T, _build.stream_handle(x.device))
        _build.check(rc, "disco_stft")
        stft_kernel.launches += 1
    out = [spec.reshape(bs + (n_freq, T))]
    return out if mag is None else out + [mag.reshape(bs + (n_freq, T))]


def _stft_fake(x, n_fft, hop, with_mag):
    shape = x.shape[:-1] + (n_fft // 2 + 1, 1 + x.shape[-1] // hop)
    spec = x.new_empty(shape, dtype=torch.complex64)
    return [spec, x.new_empty(shape, dtype=torch.float32)] if with_mag else [spec]


def _stft_plain(x, n_fft, hop, with_mag, precision):
    out = stft_matmul(x, n_fft, hop, with_mag, precision=precision)
    return list(out) if with_mag else [out]


#: the f32 and bf16 STFT kernels as named ops: ``csrc/stft.cu`` /
#: ``csrc/stft_bf16.cu`` on a CUDA tensor, :func:`stft_matmul` on a CPU tensor
_stft_op = _build.kernel_op(
    "stft(Tensor x, int n_fft, int hop, bool with_mag) -> Tensor[]",
    cuda=lambda x, n_fft, hop, with_mag: _stft_launch(x, n_fft, hop, with_mag, bf16=False),
    cpu=lambda x, n_fft, hop, with_mag: _stft_plain(x, n_fft, hop, with_mag, "f32"),
    fake=_stft_fake)
_stft_bf16_op = _build.kernel_op(
    "stft_bf16(Tensor x, int n_fft, int hop, bool with_mag) -> Tensor[]",
    cuda=lambda x, n_fft, hop, with_mag: _stft_launch(x, n_fft, hop, with_mag, bf16=True),
    cpu=lambda x, n_fft, hop, with_mag: _stft_plain(x, n_fft, hop, with_mag, "bf16"),
    fake=_stft_fake)


def _call(op, x, n_fft, hop, with_mag, name):
    if x.device.type != "cpu":
        _check_kernel_input(x, n_fft, hop, name)
    out = op(x, n_fft, hop, with_mag)
    return (out[0], out[1]) if with_mag else out[0]


def stft_kernel(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP, with_mag: bool = False):
    """The STFT kernel's wrapper (port of ``stft_pallas``, f32 lane): ``x``
    (..., L) float32 -> spec (..., F, T) complex64 [, mag (..., F, T)].

    One call of the op ``disco_torch::stft``: a CUDA tensor launches
    ``csrc/stft.cu`` (and counts the launch in ``stft_kernel.launches``),
    which pads by reflection itself and takes ``n_fft=512, hop=256`` only;
    a CPU tensor runs :func:`stft_matmul`.
    """
    return _call(_stft_op, x, n_fft, hop, with_mag, "stft_kernel")


stft_kernel.launches = 0


def stft_bf16_kernel(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP,
                     with_mag: bool = False):
    """The STFT kernel's wrapper in the bf16 lane (port of ``stft_pallas``
    with ``precision='bf16'``): the outputs of :func:`stft_kernel`.

    One call of the op ``disco_torch::stft_bf16``: a CUDA tensor launches
    ``csrc/stft_bf16.cu`` (counted in ``stft_bf16_kernel.launches``), which
    pads by reflection itself and takes ``n_fft=512, hop=256`` only; a CPU
    tensor runs ``stft_matmul(..., precision='bf16')``.
    """
    return _call(_stft_bf16_op, x, n_fft, hop, with_mag, "stft_bf16_kernel")


stft_bf16_kernel.launches = 0


def _require_cuda_f32(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}; expected 'cuda' or 'cpu'")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 signals, got {x.dtype}")


def _lane_kernel(precision: str):
    """The STFT kernel wrapper of a precision lane."""
    return stft_bf16_kernel if resolve_precision(precision) == "bf16" else stft_kernel


def stft_with_mag(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP,
                  impl: str = "auto", precision: str = "f32"):
    """Fused STFT returning ``(spec, mag)`` for all leading-axis channels in
    one pass — the analysis stage of the enhancement path (the y/s/n
    streams stack on a leading axis and transform together).  A CUDA
    tensor launches the kernel of the ``precision`` lane."""
    kernel = _lane_kernel(precision)
    check_impl(impl, x, "stft_matmul")
    return kernel(x, n_fft, hop, with_mag=True)


def stft_fused(x: torch.Tensor, n_fft: int = N_FFT, hop: int = N_HOP,
               impl: str = "auto", precision: str = "f32") -> torch.Tensor:
    """Spec-only twin of :func:`stft_with_mag`."""
    kernel = _lane_kernel(precision)
    check_impl(impl, x, "stft_matmul")
    return kernel(x, n_fft, hop)


@device_cache()
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
    return ola_finish(y, wss.reshape(-1), pad, length).reshape(bs + (length,))
