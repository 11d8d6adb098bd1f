"""Rank-1 GEVD multichannel Wiener filters (counterpart of
``disco_tpu/beam/filters.py``; reference se_utils/internal_formulas.py:56-73,
Serizel et al. 2014).

Both covariances are Hermitian PSD, so the generalized eigenproblem is
solved by Cholesky whitening and a Hermitian eigensolve:

    L = chol(Rnn + delta I),   A = L^-1 Rxx L^-H,   (lam, U) = eigh(A),   Q = L^-H U

with ``(Q^-1)[i, 0] = conj(U[0, i] L[0, 0])`` in closed form.  Everything
is batched over the leading axes.  ``torch.linalg`` carries the non-fused
solvers ('eigh', 'power', 'jacobi'), as XLA does in the reference; the
'fused*' family runs the hand-written kernel of :mod:`..ops.mwf_ops`.
"""
from __future__ import annotations

import torch

from disco_tpu_torch.core.mathx import FLOAT64_EPS
from disco_tpu_torch.solver_spec import FUSED_IMPLS, RANK1_SOLVERS, parse_solver_spec  # noqa: F401

# Eigenvalue clamp range of the reference (internal_formulas.py:6-7,59-62)
EIG_FLOOR = FLOAT64_EPS
EIG_CEIL = 1e6
# Relative diagonal loading so the float32 Cholesky exists for
# near-singular noise covariances
DIAG_LOADING = 1e-6

_JACOBI_PALLAS_TODO = ("solver 'jacobi-pallas' (the _eigh_kernel port) is slice 2 of "
                       "the port (ROADMAP.md Queue 2, item 1)")


def _herm(A: torch.Tensor) -> torch.Tensor:
    return A.conj().transpose(-1, -2)


def _trace_real(R: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(R, dim1=-2, dim2=-1).real.sum(-1)


def _load_diag(R: torch.Tensor, rel: float = DIAG_LOADING) -> torch.Tensor:
    C = R.shape[-1]
    tr = _trace_real(R) / C
    eye = torch.eye(C, dtype=R.dtype, device=R.device)
    tiny = torch.finfo(R.real.dtype).tiny
    return R + (rel * tr[..., None, None] + tiny) * eye


def _cholesky(R: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization fails (the
    reference's ``jnp.linalg.cholesky`` semantics, which the sanitize guard
    downstream relies on)."""
    L, info = torch.linalg.cholesky_ex(R)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


def _whitened(Rxx: torch.Tensor, Rnn: torch.Tensor):
    """Shared GEVD prologue: (L, A), ``L = chol(Rnn + loading)``,
    ``A = L^-1 Rxx L^-H`` re-hermitized, after the joint scale
    normalization by tr(Rnn)/C (filter-invariant)."""
    C = Rnn.shape[-1]
    tr_n = _trace_real(Rnn)[..., None, None] / C
    scale = 1.0 / tr_n.clamp_min(torch.finfo(Rnn.real.dtype).smallest_normal)
    Rxx = Rxx * scale
    Rnn = Rnn * scale
    L = _cholesky(_load_diag(Rnn))
    Li_Rxx = torch.linalg.solve_triangular(L, Rxx, upper=False)
    A = _herm(torch.linalg.solve_triangular(L, _herm(Li_Rxx), upper=False))
    return L, 0.5 * (A + _herm(A))


def _eigh_xla(A: torch.Tensor):
    """``torch.linalg.eigh`` with NaN propagation: a non-finite matrix
    yields NaN pairs instead of a LAPACK/cuSOLVER error."""
    bad = ~torch.isfinite(A).flatten(-2).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    lam, U = torch.linalg.eigh(torch.where(bad[..., None, None], eye, A))
    nan = float("nan")
    return (torch.where(bad[..., None], torch.full_like(lam, nan), lam),
            torch.where(bad[..., None, None], torch.full_like(U, nan), U))


def _sanitize(W: torch.Tensor, t1: torch.Tensor):
    """Degenerate-bin guard: non-finite filters fall back to the e1
    pass-through selector."""
    e1 = torch.zeros_like(W)
    e1[..., 0] = 1.0
    ok = torch.isfinite(W).all(-1, keepdim=True)
    return torch.where(ok, W, e1), torch.where(ok, t1, e1)


def gevd_mwf(Rxx: torch.Tensor, Rnn: torch.Tensor, mu: float = 1.0, rank=1,
             sanitize: bool = True, eigh_impl: str = "xla", sweeps: int | None = None):
    """Rank-``rank`` GEVD-MWF (the 'gevd' branch of internal_formulas.py:56-73).

    ``eigh_impl``: 'xla' (``torch.linalg.eigh``) or 'jacobi' (the plain
    fixed-sweep Jacobi of ``ops.eigh_ops``); 'jacobi-pallas' is the next
    slice.  Returns (W, t1), each (..., C).
    """
    C = Rxx.shape[-1]
    L, A = _whitened(Rxx, Rnn)
    if eigh_impl == "xla":
        lam, U = _eigh_xla(A)
    elif eigh_impl == "jacobi":
        from disco_tpu_torch.ops.eigh_ops import eigh_jacobi

        lam, U = eigh_jacobi(A, sweeps=sweeps)
    elif eigh_impl == "jacobi-pallas":
        raise NotImplementedError(_JACOBI_PALLAS_TODO)
    else:
        raise ValueError(f"unknown eigh_impl {eigh_impl!r}; expected 'xla', 'jacobi' or 'jacobi-pallas'")
    lam = lam.flip(-1).clamp(EIG_FLOOR, EIG_CEIL)
    U = U.flip(-1)
    Q = torch.linalg.solve_triangular(_herm(L), U, upper=True)
    qinv_col0 = (U[..., 0, :] * L[..., 0:1, 0]).conj()
    gains = lam / (lam + mu)
    if rank != "full":
        gains = torch.where(torch.arange(C, device=gains.device) < rank, gains, torch.zeros_like(gains))
    W = torch.einsum("...ci,...i->...c", Q, gains.to(Q.dtype) * qinv_col0)
    t1 = Q[..., :, 0] * qinv_col0[..., 0:1]
    return _sanitize(W, t1) if sanitize else (W, t1)


def gevd_mwf_power(Rxx: torch.Tensor, Rnn: torch.Tensor, mu: float = 1.0, iters: int = 12,
                   sanitize: bool = True):
    """Rank-1 GEVD-MWF by ``iters`` power iterations on the whitened
    matrix (the dominant pair only)."""
    C = Rxx.shape[-1]
    L, A = _whitened(Rxx, Rnn)
    v = torch.full(A.shape[:-1], 1.0 / C ** 0.5, dtype=A.dtype, device=A.device)
    tiny = torch.finfo(A.real.dtype).tiny
    for _ in range(iters):
        w = torch.einsum("...cd,...d->...c", A, v)
        v = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(tiny)
    lam = torch.einsum("...c,...cd,...d->...", v.conj(), A, v).real.clamp(EIG_FLOOR, EIG_CEIL)
    q1 = torch.linalg.solve_triangular(_herm(L), v[..., None], upper=True)[..., 0]
    qinv00 = (v[..., 0] * L[..., 0, 0]).conj()
    g = (lam / (lam + mu)).to(q1.dtype)
    W = q1 * (g * qinv00)[..., None]
    t1 = q1 * qinv00[..., None]
    return _sanitize(W, t1) if sanitize else (W, t1)


def rank1_gevd(Rss, Rnn, mu: float = 1.0, solver: str = "eigh", sanitize: bool = True,
               precision: str = "f32"):
    """Rank-1 GEVD-MWF by solver spec — the dispatch table of the TANGO
    steps:

    * ``'eigh'`` — :func:`gevd_mwf` at rank 1 (``torch.linalg.eigh``);
    * ``'power'`` / ``'power:N'`` — :func:`gevd_mwf_power`;
    * ``'jacobi'`` (``':N'`` sweeps) — :func:`gevd_mwf` with the plain
      Jacobi eigensolve; ``'jacobi-pallas'`` raises NotImplementedError;
    * ``'fused'`` / ``'fused-pallas'`` / ``'fused-xla'`` (``':N'`` sweeps) —
      the whole solve as one kernel (``ops.mwf_ops.rank1_gevd_fused``);
      ``'fused-xla'`` names the plain version and raises on a CUDA tensor.
    """
    base, n = parse_solver_spec(solver)
    if base == "eigh":
        return gevd_mwf(Rss, Rnn, mu=mu, rank=1, sanitize=sanitize)
    if base in FUSED_IMPLS:
        from disco_tpu_torch.ops.mwf_ops import rank1_gevd_fused

        return rank1_gevd_fused(Rss, Rnn, mu=mu, impl=FUSED_IMPLS[base], sweeps=n,
                                precision=precision, sanitize=sanitize)
    if base in ("jacobi", "jacobi-pallas"):
        return gevd_mwf(Rss, Rnn, mu=mu, rank=1, sanitize=sanitize, eigh_impl=base, sweeps=n)
    return gevd_mwf_power(Rss, Rnn, mu=mu, sanitize=sanitize, **({} if n is None else {"iters": n}))
