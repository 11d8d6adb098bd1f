"""Batched small-Hermitian eigendecomposition by fixed-sweep cyclic Jacobi
(counterpart of ``disco_tpu/ops/eigh_ops.py``).

Complex matrices are carried as float32 re/im planes (..., C, C); every
batch element rotates the same (p, q) pair in lockstep, in the
cyclic-by-rows order of :func:`_pairs`.

* :func:`eigh_jacobi_kernel` — the wrapper of the hand-written CUDA kernel
  ``csrc/eigh.cu`` (port of ``eigh_jacobi_pallas`` -> ``_eigh_kernel``),
  a thread per matrix up to C = 4 and a group of lanes per matrix with
  its planes in shared memory above, its rotation the ``jacobi_rotation``
  device function of ``csrc/common.cuh`` that the fused solve shares.  It returns the unsorted diagonal and V, as
  the Pallas kernel does, bit for bit those of :func:`eigh_jacobi_unsorted`
  on the card.  On a CPU tensor it runs :func:`eigh_jacobi_unsorted`.
* :func:`eigh_jacobi_unsorted` — the plain version: the same sweeps on
  batched PyTorch tensors.
* :func:`eigh_jacobi_pallas` — the ``'jacobi-pallas'`` seam: the wrapper,
  then the ascending stable sort outside the kernel.
* :func:`eigh_jacobi` — the plain ``'jacobi'`` eigensolve (the plain
  version, sorted).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from disco_tpu_torch.ops import _build

#: the largest matrix the kernel takes (its generic path's array bound)
MAX_CHANNELS = 16

#: the identity-rotation threshold on |A[p, q]| (sqrt of float32 tiny)
ROTATION_EPS = float(np.finfo(np.float32).tiny ** 0.5)


def _pairs(C: int):
    """Cyclic-by-rows sweep schedule: all (p, q), p < q."""
    return [(p, q) for p in range(C - 1) for q in range(p + 1, C)]


def default_sweeps(C: int) -> int:
    """Size-adaptive sweep count reaching float32 machine-precision
    residuals: 5 sweeps for C <= 5, 7 for C <= 12, else 8."""
    if C <= 5:
        return 5
    if C <= 12:
        return 7
    return 8


def _rotation(app, aqq, apq_re, apq_im, eps: float):
    """Jacobi rotation (c, sigma_re, sigma_im) zeroing the (p, q) entry:
    sigma = s e^{i phi}, phi = arg(A[p, q]); the identity where
    |A[p, q]| < eps."""
    mag = torch.sqrt(apq_re * apq_re + apq_im * apq_im)
    small = mag < eps
    mag_safe = torch.where(small, torch.ones_like(mag), mag)
    # t = tan(theta): smaller root of t^2 + 2 tau t - 1 = 0
    tau = (aqq - app) / (2.0 * mag_safe)
    rt = torch.sqrt(1.0 + tau * tau)
    t = torch.where(tau >= 0, 1.0 / (tau + rt), 1.0 / (tau - rt))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    zero = torch.zeros_like(mag)
    c = torch.where(small, torch.ones_like(mag), c)
    sig_re = torch.where(small, zero, s * (apq_re / mag_safe))
    sig_im = torch.where(small, zero, s * (apq_im / mag_safe))
    return c, sig_re, sig_im


def _apply_rotation(Ar, Ai, Vr, Vi, p: int, q: int, eps: float) -> None:
    """One (p, q) rotation in place on (..., C, C) planes: A <- G^H A G,
    V <- V G (rows first, then columns of the updated A)."""
    c, sr, si = _rotation(Ar[..., p, p], Ar[..., q, q], Ar[..., p, q], Ai[..., p, q], eps)
    c, sr, si = c[..., None], sr[..., None], si[..., None]

    # rows: (G^H A)[p] = c A[p] - sigma A[q];  (G^H A)[q] = conj(sigma) A[p] + c A[q]
    rp_r, rp_i, rq_r, rq_i = Ar[..., p, :], Ai[..., p, :], Ar[..., q, :], Ai[..., q, :]
    new = (c * rp_r - (sr * rq_r - si * rq_i), c * rp_i - (sr * rq_i + si * rq_r),
           (sr * rp_r + si * rp_i) + c * rq_r, (sr * rp_i - si * rp_r) + c * rq_i)
    Ar[..., p, :], Ai[..., p, :], Ar[..., q, :], Ai[..., q, :] = new

    # cols: (M G)[:, p] = c M[:, p] - conj(sigma) M[:, q];  (M G)[:, q] = sigma M[:, p] + c M[:, q]
    for Mr, Mi in ((Ar, Ai), (Vr, Vi)):
        cp_r, cp_i, cq_r, cq_i = Mr[..., :, p], Mi[..., :, p], Mr[..., :, q], Mi[..., :, q]
        new = (c * cp_r - (sr * cq_r + si * cq_i), c * cp_i - (sr * cq_i - si * cq_r),
               (sr * cp_r - si * cp_i) + c * cq_r, (sr * cp_i + si * cp_r) + c * cq_i)
        Mr[..., :, p], Mi[..., :, p], Mr[..., :, q], Mi[..., :, q] = new


def jacobi_sweeps(Ar, Ai, Vr, Vi, sweeps: int, eps: float = ROTATION_EPS) -> None:
    """``sweeps`` cyclic sweeps in place on (..., C, C) re/im planes."""
    for _ in range(sweeps):
        for p, q in _pairs(Ar.shape[-1]):
            _apply_rotation(Ar, Ai, Vr, Vi, p, q, eps)


def eigh_jacobi_unsorted(A: torch.Tensor, sweeps: int | None = None):
    """The plain version of :func:`eigh_jacobi_kernel`: (..., C, C)
    complex64 or float32 -> (the unsorted converged diagonal (..., C)
    float32, V (..., C, C)), complex V for complex input."""
    C = A.shape[-1]
    if sweeps is None:
        sweeps = default_sweeps(C)
    complex_in = A.is_complex()
    Ar = (A.real if complex_in else A).to(torch.float32).clone()
    Ai = A.imag.to(torch.float32).clone() if complex_in else torch.zeros_like(Ar)
    Vr = torch.eye(C, dtype=torch.float32, device=A.device).expand_as(Ar).clone()
    Vi = torch.zeros_like(Ar)
    jacobi_sweeps(Ar, Ai, Vr, Vi, sweeps)
    lam = torch.diagonal(Ar, dim1=-2, dim2=-1).contiguous()
    return lam, (torch.complex(Vr, Vi) if complex_in else Vr)


def _sort_eigpairs(lam: torch.Tensor, V: torch.Tensor):
    """Ascending eigenvalues and their eigenvector columns; the sort is
    stable and puts NaN last, as ``jnp.argsort`` does."""
    order = torch.argsort(lam, dim=-1, stable=True)
    lam = torch.take_along_dim(lam, order, dim=-1)
    V = torch.take_along_dim(V, order[..., None, :].expand_as(V), dim=-1)
    return lam, V


def eigh_jacobi(A: torch.Tensor, sweeps: int | None = None):
    """Batched Hermitian eigendecomposition, ascending like
    ``torch.linalg.eigh``: (..., C, C) complex64 or float32 ->
    (lam (..., C) float32, V (..., C, C)), complex V for complex input."""
    return _sort_eigpairs(*eigh_jacobi_unsorted(A, sweeps))


def _eigh_launch(A: torch.Tensor, sweeps: int):
    """One launch of ``csrc/eigh.cu`` on a CUDA tensor."""
    C = A.shape[-1]
    complex_in = A.is_complex()
    a = A.to(torch.complex64 if complex_in else torch.float32).contiguous()
    bs = A.shape[:-2]
    lam = torch.empty(bs + (C,), dtype=torch.float32, device=A.device)
    V = torch.empty_like(a)
    lib = _build.load()
    rc = lib.disco_eigh_jacobi(a.data_ptr(), lam.data_ptr(), V.data_ptr(), math.prod(bs), C,
                               int(complex_in), sweeps, ROTATION_EPS,
                               _build.stream_handle(A.device))
    _build.check(rc, "disco_eigh_jacobi")
    eigh_jacobi_kernel.launches += 1
    return lam, V


def _eigh_fake(A, sweeps):
    dtype = torch.complex64 if A.is_complex() else torch.float32
    return A.new_empty(A.shape[:-1], dtype=torch.float32), A.new_empty(A.shape, dtype=dtype)


#: the eigensolver kernel as a named op: ``csrc/eigh.cu`` on a CUDA tensor,
#: :func:`eigh_jacobi_unsorted` on a CPU tensor
_eigh_op = _build.kernel_op("eigh_jacobi(Tensor A, int sweeps) -> (Tensor, Tensor)",
                            cuda=_eigh_launch, cpu=eigh_jacobi_unsorted, fake=_eigh_fake)


def eigh_jacobi_kernel(A: torch.Tensor, sweeps: int | None = None):
    """The eigensolver kernel's wrapper (port of ``eigh_jacobi_pallas``'s
    ``pallas_call``): (..., C, C) Hermitian complex64 or float32 -> (the
    unsorted diagonal (..., C) float32, V (..., C, C) in the input's type).

    One call of the op ``disco_torch::eigh_jacobi``: a CUDA tensor launches
    ``csrc/eigh.cu`` (counted in ``eigh_jacobi_kernel.launches``); a CPU
    tensor runs :func:`eigh_jacobi_unsorted`.
    """
    C = A.shape[-1]
    if sweeps is None:
        sweeps = default_sweeps(C)
    if A.device.type != "cpu":
        if A.device.type != "cuda":
            raise ValueError(f"eigh_jacobi_kernel: unsupported device {A.device}; "
                             "expected 'cuda' or 'cpu'")
        if A.ndim < 2 or A.shape[-2] != C or not 1 <= C <= MAX_CHANNELS:
            raise ValueError(f"eigh_jacobi_kernel: matrices {tuple(A.shape[-2:])}; the kernel "
                             f"takes square matrices up to {MAX_CHANNELS}x{MAX_CHANNELS}")
        if sweeps < 0:
            raise ValueError(f"eigh_jacobi_kernel: sweeps must be >= 0, got {sweeps}")
    return _eigh_op(A, sweeps)


eigh_jacobi_kernel.launches = 0


def eigh_jacobi_pallas(A: torch.Tensor, sweeps: int | None = None):
    """The ``'jacobi-pallas'`` eigensolve (counterpart of
    ``eigh_jacobi_pallas``): :func:`eigh_jacobi_kernel`, then the ascending
    stable sort outside the kernel.  Returns (lam (..., C) float32, V),
    complex64 V for complex input; on a CPU tensor it equals
    :func:`eigh_jacobi`."""
    return _sort_eigpairs(*eigh_jacobi_kernel(A, sweeps))
