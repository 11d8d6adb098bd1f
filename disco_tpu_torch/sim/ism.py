"""Image-source room impulse responses and FFT convolution in plain torch
(counterpart of ``disco_tpu/sim/ism.py``).

The reference delegates RIR computation to pyroomacoustics' C++ ``libroom``
engine (``gen_disco/convolve_signals.py:84-99``); the JAX package computes
the Allen & Berkley shoebox model as one XLA program, and so does this
module in torch, on the device of its inputs:

* image enumeration for ``|n|+|l|+|m| <= max_order`` is a static host
  lattice (:func:`image_lattice`, 11,521 images at order 20),
* per-image positions, reflection counts, distances and amplitudes are one
  broadcast over (RIR rows, images),
* each image's fractional delay is an 81-tap windowed sinc (Hann, the
  libroom convention) added into the RIR buffer by one ordered scatter
  (:func:`_accumulate`).

Every function reduces to :func:`_rir_rows` over RIR rows, each one
(room, source, mic) triple.  Eager torch materializes the
``(rows, images, 81)`` chain that XLA fuses (at order 20 a row holds 0.93 M
elements), so the rows go in chunks of at most :data:`ROW_ELEMENTS`
elements.  A row's scatter touches its own slice of the buffer only, and
sums the contributions to one sample in their order, with no atomics
(:func:`_accumulate`).  So a row's RIR does not depend on the chunking or
on the other rows of its batch, bit for bit, and two runs on the card
agree bit for bit: the batched generator's crash-and-resume promise rests
on that.

Conventions matched to pyroomacoustics: sound speed c = 343 m/s, uniform
wall energy absorption ``alpha`` (reflection coefficient sqrt(1-alpha)),
amplitude 1/(4·pi·d), fs 16 kHz.

Device rule: a function given tensors runs on their device; given numpy
(or Python numbers) only, on ``device`` (``"cuda"`` when None, RuntimeError
without a CUDA device).  Results are float32 tensors.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from disco_tpu_torch.device import as_device_tensors, device_cache

C_SOUND = 343.0
FDL = 81  # fractional-delay filter length (libroom's windowed-sinc taps)

#: the most elements of the (rows, images, FDL) chain built at once: ~0.7 GB
#: of live float32/int64 intermediates, 35 RIR rows at order 20
ROW_ELEMENTS = 1 << 25


@lru_cache(maxsize=None)
def image_lattice(max_order: int) -> tuple[np.ndarray, np.ndarray]:
    """Static image lattice for the shoebox ISM.

    Returns (lattice, parity):
      lattice: (n_img, 3) int — the (n, l, m) cell indices,
      parity:  (n_img, 3) int in {0, 1} — the (u, v, w) mirror parities,
    enumerating every image with total reflection count
    ``|n-u|+|n| + |l-v|+|l| + |m-w|+|m| <= max_order`` (Allen & Berkley 1979;
    the sum-order truncation libroom applies).
    """
    rng = np.arange(-max_order, max_order + 1)
    cells = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    par = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(-1, 3)
    lat = np.repeat(cells, len(par), axis=0)
    pr = np.tile(par, (len(cells), 1))
    n_refl = np.abs(lat - pr).sum(-1) + np.abs(lat).sum(-1)
    keep = n_refl <= max_order
    return lat[keep].astype(np.int32), pr[keep].astype(np.int32)


@device_cache()
def _lattice_tensors(max_order: int, device: str):
    """(lattice, parity, reflection counts) as float32 tensors on ``device``."""
    lat_np, par_np = image_lattice(max_order)
    lat = torch.from_numpy(lat_np).to(device=device, dtype=torch.float32)
    par = torch.from_numpy(par_np).to(device=device, dtype=torch.float32)
    n_refl = (lat - par).abs().sum(-1) + lat.abs().sum(-1)
    return lat, par, n_refl


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and the card take
    it: by way of float64 (torch's vectorized float32 ``sqrt`` on the CPU is
    off by an ulp on ~1 % of inputs)."""
    return torch.sqrt(x.double()).float()


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """|x| over a last axis of size 3 in the JAX package's float32
    arithmetic on the CPU: XLA fuses ``jnp.linalg.norm`` into
    ``sqrt(fma(x2, x2, fma(x1, x1, x0 x0)))``.  Each fused multiply-add is
    taken in float64, where the product of two float32 is exact, then
    rounded once to float32, so the card and the host compute the same
    distances (a last-bit change of a distance moves an image's delay by up
    to 1e-4 samples, ~1e-5 of a RIR)."""
    x64 = x.double()
    acc = (x[..., 0] * x[..., 0]).double()
    acc = (x64[..., 1] * x64[..., 1] + acc).float().double()
    return _sqrt_rn((x64[..., 2] * x64[..., 2] + acc).float())


def _scatter_rows(buf, dims, srcs, mics, alphas, max_order: int, rir_len: int, fs: int):
    """Add the images of ``len(buf)`` RIR rows into ``buf`` (rows, rir_len + 1),
    in the arithmetic of ``disco_tpu/sim/ism.py::shoebox_rir``: row r is the
    RIR from ``srcs[r]`` to ``mics[r]`` in room ``dims[r]`` of absorption
    ``alphas[r]``; out-of-range taps land in the last column.

    The transcendental functions run row by row: on the CPU their vectorized
    and scalar loops differ in the last bit, and which loop an element
    takes depends on the size of the tensor, so a row computed alone is
    computed as in any chunk or batch (on the card it changes nothing)."""
    lat, par, n_refl = _lattice_tensors(max_order, str(buf.device))
    rows, half = buf.shape[0], FDL // 2
    # image positions x_im = (1-2u) x_s + 2 n L, per axis: (rows, I, 3)
    img = (1.0 - 2.0 * par) * srcs[:, None, :] + 2.0 * lat * dims[:, None, :]
    d = _norm3(img - mics[:, None, :]).clamp_min(1e-3)                 # (rows, I)
    del img
    beta = _sqrt_rn(torch.clamp_min(1.0 - alphas, 0.0))
    amp = torch.stack([b ** n_refl for b in beta]) / (4.0 * math.pi * d)
    delay = d * (fs / C_SOUND)                                         # fractional samples
    t0 = torch.floor(delay)
    frac = delay - t0
    # windowed-sinc fractional delay: FDL taps centred on each delay
    taps = torch.arange(-half, half + 1, dtype=torch.float32, device=buf.device)
    arg = taps - frac[..., None]                                       # (rows, I, FDL)
    win = math.pi * arg / (half + 1)
    for w in win:
        w.cos_()
    win.add_(1.0).mul_(0.5)
    win.masked_fill_(arg.abs() > half + 1, 0.0)
    vals = torch.empty_like(arg)
    for a, v in zip(arg, vals):
        torch.sinc(a, out=v)
    del arg
    vals.mul_(win).mul_(amp[..., None])
    del win
    idx = t0.to(torch.int64)[..., None] + taps.to(torch.int64)
    oob = (idx < 0) | (idx >= rir_len)
    idx.masked_fill_(oob, rir_len)
    vals.masked_fill_(oob, 0.0)
    del oob
    idx += (torch.arange(rows, device=buf.device) * (rir_len + 1))[:, None, None]
    _accumulate(buf.view(-1), idx.view(-1), vals.view(-1))


def _accumulate(flat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``flat[idx[i]] += vals[i]`` for every i, each sample summing its
    contributions in their order in ``vals``, with no atomics: on a CUDA
    tensor ``index_put_(accumulate=True)`` (a stable sort of the indices,
    then an ordered reduction of each run of equal indices), on the CPU
    ``index_add_`` (a serial loop; the CPU's ``index_put_`` splits the work
    by size)."""
    if flat.is_cuda:
        flat.index_put_((idx,), vals, accumulate=True)
    else:
        flat.index_add_(0, idx, vals)


def _rir_rows(dims, srcs, mics, alphas, max_order: int, rir_len: int, fs: int,
              budget: int = ROW_ELEMENTS) -> torch.Tensor:
    """(rows, rir_len) float32 RIRs of RIR rows (``dims``, ``srcs``, ``mics``
    (rows, 3) and ``alphas`` (rows,) float32 tensors on one device), built in
    chunks of at most ``budget`` chain elements (at least one row)."""
    n_img = len(image_lattice(max_order)[0])
    rows = dims.shape[0]
    out = torch.zeros((rows, rir_len + 1), dtype=torch.float32, device=dims.device)
    step = max(1, budget // (n_img * FDL))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        _scatter_rows(out[r0:r1], dims[r0:r1], srcs[r0:r1], mics[r0:r1], alphas[r0:r1],
                      max_order, rir_len, fs)
    return out[:, :rir_len]


def shoebox_rir(room_dim, source, mics, alpha, max_order: int = 20, rir_len: int = 8192,
                fs: int = 16000, device=None) -> torch.Tensor:
    """RIRs from one source to M mics in a shoebox room.

    Args:
      room_dim: (3,) room dimensions [Lx, Ly, Lz] in meters.
      source: (3,) source position.
      mics: (M, 3) microphone positions.
      alpha: scalar energy absorption of all walls (the Eyring-calibrated
        value of reference room_setups.py:92).
      max_order: maximum total reflection count (reference uses 20,
        convolve_signals.py:245).
      rir_len: output length in samples (images arriving later are
        dropped, as a finite libroom RIR does).

    Returns:
      (M, rir_len) float32 RIRs.
    """
    room_dim, source, mics = as_device_tensors((room_dim, source, mics), device)
    return shoebox_rirs(room_dim, source[None], mics, alpha, max_order, rir_len, fs)[0]


def shoebox_rirs(room_dim, sources, mics, alpha, max_order: int = 20, rir_len: int = 8192,
                 fs: int = 16000, device=None) -> torch.Tensor:
    """(S, 3) sources × (M, 3) mics -> (S, M, rir_len) RIRs."""
    room_dim, sources, mics, alpha = as_device_tensors((room_dim, sources, mics, alpha), device)
    return shoebox_rirs_batched(room_dim[None], sources[None], mics[None], alpha.reshape(1),
                                max_order, rir_len, fs)[0]


def shoebox_rirs_batched(room_dims, sources, mics, alphas, max_order: int = 20,
                         rir_len: int = 8192, fs: int = 16000, device=None) -> torch.Tensor:
    """A (B,) batch of rooms — B × S sources × M mics.

    The image lattice is one static host constant shared by every room;
    the B · S · M RIRs are rows of one scatter (in chunks, module
    docstring).  The reference simulates rooms one ``pra.ShoeBox`` at a
    time (``gen_disco/convolve_signals.py:84-99``).

    Args:
      room_dims: (B, 3) room dimensions.
      sources: (B, S, 3) source positions per room.
      mics: (B, M, 3) mic positions per room.
      alphas: (B,) wall energy absorption per room.
      max_order/rir_len: the bucket — pick via :func:`rir_bucket` (shared
        across the batch).

    Returns:
      (B, S, M, rir_len) float32 RIRs.
    """
    room_dims, sources, mics, alphas = as_device_tensors((room_dims, sources, mics, alphas),
                                                         device)
    B, S, M = sources.shape[0], sources.shape[1], mics.shape[1]
    shape = (B, S, M, 3)
    rirs = _rir_rows(room_dims[:, None, None, :].expand(shape).reshape(-1, 3),
                     sources[:, :, None, :].expand(shape).reshape(-1, 3),
                     mics[:, None, :, :].expand(shape).reshape(-1, 3),
                     alphas[:, None, None].expand(B, S, M).reshape(-1),
                     int(max_order), int(rir_len), int(fs))
    return rirs.reshape(B, S, M, rir_len)


def rir_bucket(
    beta: float,
    room_dim=None,
    max_order: int = 20,
    fs: int = 16000,
    margin: float = 1.3,
    quantum: int = 256,
) -> tuple[int, int]:
    """The canonical ``(max_order, rir_len)`` bucket for one scene.

    This is the ONE place the RIR-buffer policy lives (the reference lets
    pyroomacoustics size the RIR from the actual image set,
    ``gen_disco/convolve_signals.py:84-99``).  Two bounds are combined:

    * the RT60 bound — ``beta * margin`` seconds of tail, and
    * the order-coverage bound — when ``room_dim`` is given, the arrival
      time of the farthest order-``max_order`` image,
      ``|(2*max_order + 1) * room_dim| / c``, plus the FDL half-width: a
      buffer longer than that only holds zeros.

    ``rir_len`` is rounded up to ``quantum`` (the batched paths pass a
    coarser quantum).  Returns ``(max_order, rir_len)``.
    """
    rt60_len = int(np.ceil(float(beta) * margin * fs))
    rir_len = rt60_len
    if room_dim is not None:
        dim = np.asarray(room_dim, np.float64).reshape(-1, 3)
        far = float(np.max(np.linalg.norm((2 * max_order + 1) * dim, axis=-1)))
        order_len = int(np.ceil(far * fs / C_SOUND)) + FDL // 2 + 1
        rir_len = min(rir_len, order_len)
    rir_len = max(rir_len, FDL)
    rir_len = int(np.ceil(rir_len / quantum) * quantum)
    return max_order, rir_len


def rir_length_for(beta: float, fs: int = 16000, margin: float = 1.3) -> int:
    """An RIR length covering an RT60 of ``beta`` seconds: :func:`rir_bucket`
    without a ``room_dim`` (the RT60-only sizing)."""
    return rir_bucket(beta, None, fs=fs, margin=margin)[1]


def fft_convolve(signals, rirs, out_len: int, device=None) -> torch.Tensor:
    """Batched linear convolution via rFFT (the reference's per-channel
    ``np.convolve`` loops, convolve_signals.py:161, and ``room.simulate``).

    Args:
      signals: (..., L) float.
      rirs: (..., R) float, broadcast-compatible leading axes.
      out_len: output length (<= L + R - 1); typically L.

    Returns:
      (..., out_len) float32: the ``irfft`` of the product of the two
      ``rfft`` at ``nfft``, the power of two >= L + R - 1.
    """
    signals, rirs = as_device_tensors((signals, rirs), device)
    n = signals.shape[-1] + rirs.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    out = torch.fft.irfft(torch.fft.rfft(signals, nfft) * torch.fft.rfft(rirs, nfft), nfft)
    return out[..., :out_len].to(torch.float32).contiguous()
