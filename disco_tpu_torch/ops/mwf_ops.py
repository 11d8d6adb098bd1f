"""The fused rank-1 GEVD-MWF solve — counterpart of
``disco_tpu/ops/mwf_ops.py``.

Per (C, C) Hermitian pencil (Rss, Rnn) and its mu, one chain:

    scale-normalize by tr(Rnn)/C -> diagonal load 1e-6 tr/C + tiny
    -> complex Cholesky L of Rnn -> A = L^-1 Rss L^-H (re-hermitized)
    -> default_sweeps(C) cyclic Jacobi sweeps with V -> dominant pair by a
    strict running max -> lam clipped to [EIG_FLOOR, EIG_CEIL]
    -> q1 = L^-H u1 -> W = q1 lam/(lam+mu) conj(u1[0] L00), t1 = q1 conj(u1[0] L00)

Only W and t1 (..., C) are produced; NaNs propagate (the e1 sanitize step
is :func:`rank1_gevd_fused`'s).  The bf16 lane (``precision='bf16'``)
rounds the real and imaginary planes of both pencils to bf16 at load and
runs the f32 chain on them (``ops/resolve.py``'s rounding points).

* :func:`fused_mwf_kernel` — the wrapper of the hand-written CUDA kernel
  ``csrc/mwf.cu`` (port of ``fused_mwf_pallas`` -> ``_mwf_kernel``), a
  thread per pencil up to C = 4, a group of lanes per pencil above, and
  its bf16 instances.  On a CPU tensor it runs :func:`fused_mwf_plain`.
* :func:`fused_mwf_plain` — the plain version: the exact chain of
  ``_mwf_kernel`` (element-wise Cholesky and whitening, the same rotation
  order and guard, the same running max) on batched PyTorch tensors.
* :func:`rank1_gevd_fused` — the ``'fused*'`` solver seam.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from disco_tpu_torch.beam.filters import DIAG_LOADING, EIG_CEIL, EIG_FLOOR, _sanitize
from disco_tpu_torch.ops import _build
from disco_tpu_torch.ops.eigh_ops import ROTATION_EPS, default_sweeps, jacobi_sweeps
from disco_tpu_torch.ops.resolve import bf16_round, check_impl, resolve_precision

#: the largest pencil size the kernel takes (its generic path's array bound)
MAX_CHANNELS = 16
_FLT_MIN = float(np.finfo(np.float32).tiny)
_LAM_FLOOR = float(np.float32(EIG_FLOOR))


def _planes(R: torch.Tensor, C: int):
    """(B, C, C) float32 re/im planes of a (..., C, C) complex or real
    batch."""
    R = R.reshape(-1, C, C)
    if R.is_complex():
        return R.real.to(torch.float32), R.imag.to(torch.float32)
    return R.to(torch.float32), torch.zeros(R.shape, dtype=torch.float32, device=R.device)


def _mu_per_pencil(mu, batch_shape, device) -> torch.Tensor:
    return torch.as_tensor(mu, dtype=torch.float32, device=device).expand(batch_shape).reshape(-1)


def _mu_argument(mu, batch_shape, device):
    """mu as the kernel takes it: (float32 device tensor or None, stride,
    value).  A number, or one value on the host, goes by value; one value
    on the device by its pointer with stride 0; one value per pencil as a
    contiguous (n,) float32 array on the pencils' device, copied only when
    it is not one already."""
    if not isinstance(mu, torch.Tensor):
        if np.ndim(mu) == 0:
            return None, 0, float(mu)
        mu = torch.as_tensor(mu, device=device)
    if mu.numel() == 1 and mu.device.type == "cpu":
        return None, 0, float(mu)
    mu = mu.to(device=device, dtype=torch.float32)
    if mu.numel() == 1:
        return mu, 0, 0.0
    return mu.expand(batch_shape).reshape(-1).contiguous(), 1, 0.0


def fused_mwf_plain(Rss: torch.Tensor, Rnn: torch.Tensor, mu=1.0, sweeps: int | None = None,
                    precision: str = "f32"):
    """The plain version of :func:`fused_mwf_kernel` — ``_mwf_kernel``'s
    chain step for step on (B,)-shaped element tensors, from the pencils'
    planes rounded to bf16 in the bf16 lane.  Returns (W, t1), each (..., C)
    complex64, unsanitized."""
    C = Rss.shape[-1]
    if sweeps is None:
        sweeps = default_sweeps(C)
    bs = Rss.shape[:-2]
    Sr, Si = _planes(Rss, C)
    Nr, Ni = _planes(Rnn, C)
    if resolve_precision(precision) == "bf16":
        Sr, Si, Nr, Ni = (bf16_round(p) for p in (Sr, Si, Nr, Ni))
    mu = _mu_per_pencil(mu, bs, Rss.device)

    # joint scale normalization (filter-invariant)
    tr = Nr[:, 0, 0]
    for c in range(1, C):
        tr = tr + Nr[:, c, c]
    scale = (1.0 / (tr * (1.0 / C)).clamp_min(_FLT_MIN))[:, None, None]
    Sr, Si, Nr, Ni = Sr * scale, Si * scale, Nr * scale, Ni * scale

    # relative diagonal loading
    tr2 = Nr[:, 0, 0]
    for c in range(1, C):
        tr2 = tr2 + Nr[:, c, c]
    load = DIAG_LOADING * (tr2 * (1.0 / C)) + _FLT_MIN

    # element-wise complex Cholesky (NaN for a non-PSD pencil)
    Lr: dict = {}
    Li: dict = {}
    inv: dict = {}
    for j in range(C):
        d = Nr[:, j, j] + load
        for k in range(j):
            d = d - (Lr[j, k] * Lr[j, k] + Li[j, k] * Li[j, k])
        ljj = torch.sqrt(d)
        inv[j] = 1.0 / ljj
        Lr[j, j], Li[j, j] = ljj, torch.zeros_like(ljj)
        for i in range(j + 1, C):
            ar, ai = Nr[:, i, j], Ni[:, i, j]
            for k in range(j):
                ar = ar - (Lr[i, k] * Lr[j, k] + Li[i, k] * Li[j, k])
                ai = ai - (Li[i, k] * Lr[j, k] - Lr[i, k] * Li[j, k])
            Lr[i, j], Li[i, j] = ar * inv[j], ai * inv[j]

    # whitening: forward solve L B = Rss by rows, then L M = B^H
    Br: list = []
    Bi: list = []
    for i in range(C):
        rr, ri = Sr[:, i], Si[:, i]
        for k in range(i):
            lr, li = Lr[i, k][:, None], Li[i, k][:, None]
            rr = rr - (lr * Br[k] - li * Bi[k])
            ri = ri - (lr * Bi[k] + li * Br[k])
        Br.append(rr * inv[i][:, None])
        Bi.append(ri * inv[i][:, None])
    BrT = torch.stack(Br, dim=1).transpose(1, 2)   # [:, i, j] = B[j, i]
    BiT = torch.stack(Bi, dim=1).transpose(1, 2)
    Mr: list = []
    Mi: list = []
    for i in range(C):
        rr, ri = BrT[:, i], -BiT[:, i]               # B^H[i, :]
        for k in range(i):
            lr, li = Lr[i, k][:, None], Li[i, k][:, None]
            rr = rr - (lr * Mr[k] - li * Mi[k])
            ri = ri - (lr * Mi[k] + li * Mr[k])
        Mr.append(rr * inv[i][:, None])
        Mi.append(ri * inv[i][:, None])
    Mr_, Mi_ = torch.stack(Mr, dim=1), torch.stack(Mi, dim=1)
    Ar = 0.5 * (Mr_.transpose(1, 2) + Mr_)
    Ai = 0.5 * (Mi_ - Mi_.transpose(1, 2))

    # fixed-sweep cyclic Jacobi with eigenvector accumulation
    Vr = torch.eye(C, dtype=torch.float32, device=Ar.device).expand_as(Ar).clone()
    Vi = torch.zeros_like(Ar)
    jacobi_sweeps(Ar, Ai, Vr, Vi, sweeps, ROTATION_EPS)

    # dominant pair: strict running max over the converged diagonal
    best = Ar[:, 0, 0]
    ur, ui = Vr[:, :, 0], Vi[:, :, 0]
    for c in range(1, C):
        better = Ar[:, c, c] > best
        best = torch.where(better, Ar[:, c, c], best)
        ur = torch.where(better[:, None], Vr[:, :, c], ur)
        ui = torch.where(better[:, None], Vi[:, :, c], ui)
    lam1 = best.clamp(_LAM_FLOOR, EIG_CEIL)

    # back-substitution q1 = L^-H u1
    qr: dict = {}
    qi: dict = {}
    for i in reversed(range(C)):
        rr, ri = ur[:, i], ui[:, i]
        for k in range(i + 1, C):
            lr, li = Lr[k, i], -Li[k, i]
            rr = rr - (lr * qr[k] - li * qi[k])
            ri = ri - (lr * qi[k] + li * qr[k])
        qr[i], qi[i] = rr * inv[i], ri * inv[i]

    # filter formation: (Q^-1)[0, 0] = conj(u1[0] L00)
    qinv_r = ur[:, 0] * Lr[0, 0]
    qinv_i = -ui[:, 0] * Lr[0, 0]
    g = lam1 / (lam1 + mu)
    cr, ci = g * qinv_r, g * qinv_i
    Qr = torch.stack([qr[i] for i in range(C)], dim=-1)
    Qi = torch.stack([qi[i] for i in range(C)], dim=-1)
    cr, ci, qinv_r, qinv_i = cr[:, None], ci[:, None], qinv_r[:, None], qinv_i[:, None]
    W = torch.complex(Qr * cr - Qi * ci, Qr * ci + Qi * cr)
    t1 = torch.complex(Qr * qinv_r - Qi * qinv_i, Qr * qinv_i + Qi * qinv_r)
    return W.reshape(bs + (C,)), t1.reshape(bs + (C,))


def fused_mwf_kernel(Rss: torch.Tensor, Rnn: torch.Tensor, mu=1.0, sweeps: int | None = None,
                     precision: str = "f32"):
    """The fused-solve kernel's wrapper (port of ``fused_mwf_pallas``):
    (..., C, C) pencils and a scalar or per-pencil ``mu`` -> (W, t1), each
    (..., C) complex64, unsanitized.

    A CUDA tensor launches ``csrc/mwf.cu``, its bf16 instances under
    ``precision='bf16'`` (counted in ``fused_mwf_kernel.launches`` and
    ``fused_mwf_kernel.launches_bf16``); a CPU tensor runs
    :func:`fused_mwf_plain`.
    """
    bf16 = resolve_precision(precision) == "bf16"
    if Rss.device.type == "cpu":
        return fused_mwf_plain(Rss, Rnn, mu, sweeps, precision)
    if Rss.device.type != "cuda" or Rnn.device != Rss.device:
        raise ValueError(f"fused_mwf_kernel: pencils on {Rss.device} and {Rnn.device}; "
                         "expected both on one CUDA device (or the CPU)")
    if Rss.shape != Rnn.shape:
        raise ValueError(f"fused_mwf_kernel: Rss {tuple(Rss.shape)} vs Rnn {tuple(Rnn.shape)}")
    C = Rss.shape[-1]
    if not 1 <= C <= MAX_CHANNELS or Rss.shape[-2] != C:
        raise ValueError(f"fused_mwf_kernel: pencils {tuple(Rss.shape[-2:])}; the kernel "
                         f"takes square pencils up to {MAX_CHANNELS}x{MAX_CHANNELS}")
    if sweeps is None:
        sweeps = default_sweeps(C)
    bs = Rss.shape[:-2]
    # each the input itself when it is contiguous complex64 already
    rss = Rss.to(torch.complex64).contiguous()
    rnn = Rnn.to(torch.complex64).contiguous()
    mu_t, mu_stride, mu_value = _mu_argument(mu, bs, Rss.device)
    W = torch.empty(bs + (C,), dtype=torch.complex64, device=Rss.device)
    t1 = torch.empty_like(W)
    lib = _build.load()
    mu_ptr = None if mu_t is None else mu_t.data_ptr()
    rc = lib.disco_fused_mwf(rss.data_ptr(), rnn.data_ptr(), mu_ptr, mu_stride, mu_value,
                             W.data_ptr(), t1.data_ptr(), math.prod(bs), C, sweeps, ROTATION_EPS,
                             DIAG_LOADING, _LAM_FLOOR, EIG_CEIL, int(bf16),
                             _build.stream_handle(Rss.device))
    _build.check(rc, "disco_fused_mwf")
    if bf16:
        fused_mwf_kernel.launches_bf16 += 1
    else:
        fused_mwf_kernel.launches += 1
    return W, t1


fused_mwf_kernel.launches = 0
fused_mwf_kernel.launches_bf16 = 0


def rank1_gevd_fused(Rss, Rnn, mu=1.0, impl: str = "auto", sweeps: int | None = None,
                     precision: str = "f32", sanitize: bool = True):
    """The fused rank-1 GEVD-MWF solve behind the ``'fused*'`` solver specs:
    the hand-written kernel of the ``precision`` lane on a CUDA tensor
    (``'auto'``/``'pallas'``), the plain chain on a CPU tensor; ``'xla'`` on
    a CUDA tensor raises.  ``sanitize`` replaces non-finite filters by the
    e1 selector."""
    precision = resolve_precision(precision)
    check_impl(impl, Rss, "fused_mwf_plain")
    W, t1 = fused_mwf_kernel(Rss, Rnn, mu=mu, sweeps=sweeps, precision=precision)
    return _sanitize(W, t1) if sanitize else (W, t1)
