"""Batched small-Hermitian eigendecomposition by fixed-sweep cyclic Jacobi
(counterpart of ``disco_tpu/ops/eigh_ops.py``, the plain functions).

Complex matrices are carried as float32 re/im planes (..., C, C); every
batch element rotates the same (p, q) pair in lockstep, in the
cyclic-by-rows order of :func:`_pairs`.  The hand-written kernel of
``eigh_jacobi_pallas`` (``_eigh_kernel``) is the next slice of the port;
its rotation is already the ``jacobi_rotation`` device function of
``csrc/common.cuh``, shared with the fused solve.
"""
from __future__ import annotations

import numpy as np
import torch

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


def eigh_jacobi(A: torch.Tensor, sweeps: int | None = None):
    """Batched Hermitian eigendecomposition, ascending like
    ``torch.linalg.eigh``: (..., C, C) complex64 or float32 ->
    (lam (..., C) float32, V (..., C, C)), complex V for complex input."""
    C = A.shape[-1]
    if sweeps is None:
        sweeps = default_sweeps(C)
    complex_in = A.is_complex()
    Ar = (A.real if complex_in else A).to(torch.float32).clone()
    Ai = A.imag.to(torch.float32).clone() if complex_in else torch.zeros_like(Ar)
    Vr = torch.eye(C, dtype=torch.float32, device=A.device).expand_as(Ar).clone()
    Vi = torch.zeros_like(Ar)
    jacobi_sweeps(Ar, Ai, Vr, Vi, sweeps)
    lam = torch.diagonal(Ar, dim1=-2, dim2=-1)
    order = torch.argsort(lam, dim=-1, stable=True)
    lam = torch.take_along_dim(lam, order, dim=-1)
    idx = order[..., None, :].expand_as(Vr)
    Vr = torch.take_along_dim(Vr, idx, dim=-1)
    Vi = torch.take_along_dim(Vi, idx, dim=-1)
    return lam, (torch.complex(Vr, Vi) if complex_in else Vr)
