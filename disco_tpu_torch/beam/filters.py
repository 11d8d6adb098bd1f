"""Rank-1 GEVD multichannel Wiener filters (counterpart of
``disco_tpu/beam/filters.py``; reference se_utils/internal_formulas.py:56-73,
Serizel et al. 2014).

Both covariances are Hermitian PSD, so the generalized eigenproblem is
solved by Cholesky whitening and a Hermitian eigensolve:

    L = chol(Rnn + delta I),   A = L^-1 Rxx L^-H,   (lam, U) = eigh(A),   Q = L^-H U

with ``(Q^-1)[i, 0] = conj(U[0, i] L[0, 0])`` in closed form.  Everything
is batched over the leading axes.  ``torch.linalg`` carries the
'eigh' and 'power' solvers, as XLA does in the reference; 'jacobi-pallas'
runs the hand-written eigensolver kernel of :mod:`..ops.eigh_ops` and the
'fused*' family the fused-solve kernel of :mod:`..ops.mwf_ops`.  'jacobi'
names that kernel's plain version, which runs on CPU tensors only, as
'fused-xla' does for the fused solve.
"""
from __future__ import annotations

import re

import torch

from disco_tpu_torch.core.mathx import FLOAT64_EPS
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.solver_spec import FUSED_IMPLS, RANK1_SOLVERS, parse_solver_spec  # noqa: F401

# Eigenvalue clamp range of the reference (internal_formulas.py:6-7,59-62)
EIG_FLOOR = FLOAT64_EPS
EIG_CEIL = 1e6
# Relative diagonal loading so the float32 Cholesky exists for
# near-singular noise covariances
DIAG_LOADING = 1e-6
# Matrices per torch.linalg.eigh call on a CUDA tensor (_eigh_batches)
EIGH_BATCH = 16384


def get_filter_type(name: str):
    """Parse a filter spec like 'gevd', 'rank2-gevd', 'rank12-gevd',
    'gevd-power', 'r1-mwf', 'mwf' (internal_formulas.py:10-28):
    returns (type, rank)."""
    if name == "gevd-power":
        return "gevd-power", 1
    if "gevd" in name:
        if "-" in name:
            m = re.fullmatch(r"rank(\d+)-gevd", name)
            if m is None:
                raise ValueError(
                    f"malformed GEVD filter spec {name!r}; expected 'gevd', 'rankN-gevd' or 'gevd-power'"
                )
            return "gevd", int(m.group(1))
        return "gevd", "full"
    return name, None


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


def _eigh_batches(A: torch.Tensor):
    """``torch.linalg.eigh`` of a stack of matrices; on a CUDA tensor in
    batches of exactly :data:`EIGH_BATCH` matrices, the last padded with
    identities.  cuSOLVER's batched eigensolver refuses the batches a
    streaming step hands it at the north-star width (8 x 16 x 257 pencils
    a 64-frame block, 8 x 157 x 257 a 10-s clip:
    ``CUSOLVER_STATUS_INVALID_VALUE``), and one batch size for every call
    keeps a matrix's eigenpairs independent of how many others came with
    it, so a stream served block by block equals the whole-clip stream bit
    for bit (``exp/serve_parity_probe.py``)."""
    if A.device.type != "cuda":
        return torch.linalg.eigh(A)
    lead, n = A.shape[:-2], A.shape[-1]
    flat = A.reshape(-1, n, n)
    m = flat.shape[0]
    pad = (-m) % EIGH_BATCH
    if pad:
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        flat = torch.cat([flat, eye.expand(pad, n, n)])
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_BATCH)]
    lam = torch.cat([p[0] for p in parts])[:m]
    U = torch.cat([p[1] for p in parts])[:m]
    return lam.reshape(lead + (n,)), U.reshape(lead + (n, n))


def _eigh_xla(A: torch.Tensor):
    """``torch.linalg.eigh`` with NaN propagation: a non-finite matrix
    yields NaN pairs instead of a LAPACK/cuSOLVER error."""
    bad = ~torch.isfinite(A).flatten(-2).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    lam, U = _eigh_batches(torch.where(bad[..., None, None], eye, A))
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

    ``eigh_impl``: 'xla' (``torch.linalg.eigh``), 'jacobi' (the plain
    fixed-sweep Jacobi of ``ops.eigh_ops``: the eigensolver kernel's plain
    version, so a CUDA tensor raises ValueError) or 'jacobi-pallas' (the
    hand-written kernel on a CUDA tensor, the plain version on a CPU
    tensor).  Returns (W, t1), each (..., C).
    """
    C = Rxx.shape[-1]
    L, A = _whitened(Rxx, Rnn)
    if eigh_impl == "xla":
        lam, U = _eigh_xla(A)
    elif eigh_impl == "jacobi":
        from disco_tpu_torch.ops.eigh_ops import eigh_jacobi

        if A.device.type != "cpu":
            raise ValueError(
                "eigh_impl='jacobi' selects eigh_jacobi, the plain version of the eigensolver "
                "kernel, which never runs on a CUDA tensor; use 'jacobi-pallas' (the "
                "hand-written kernel)"
            )
        lam, U = eigh_jacobi(A, sweeps=sweeps)
    elif eigh_impl == "jacobi-pallas":
        from disco_tpu_torch.ops.eigh_ops import eigh_jacobi_pallas

        lam, U = eigh_jacobi_pallas(A, sweeps=sweeps)
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
    * ``'jacobi'`` / ``'jacobi-pallas'`` (``':N'`` sweeps) — :func:`gevd_mwf`
      with the plain Jacobi eigensolve / the eigensolver kernel; ``'jacobi'``
      names the plain version and raises on a CUDA tensor;
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


def solver_lane_info(spec: str, device=None) -> dict:
    """What a solver spec runs on ``device`` (``"cuda"`` when None): the
    parsed base and N, and ``impl`` — ``'cuda'`` for the hand-written
    kernel ('fused', 'fused-pallas', 'jacobi-pallas' on a CUDA device),
    ``'plain'`` for its plain version (those specs on the CPU, and
    'fused-xla' / 'jacobi'), ``'torch'`` for the ``torch.linalg``
    formulations ('eigh', 'power').  The JAX package's function of the same
    name names its own backends ('pallas' / 'xla')."""
    base, n = parse_solver_spec(spec)
    if base in ("fused", "fused-pallas", "jacobi-pallas"):
        impl = "cuda" if resolve_device(device).type == "cuda" else "plain"
    elif base in ("fused-xla", "jacobi"):
        impl = "plain"
    else:
        impl = "torch"
    return {"spec": spec, "base": base, "n": n, "impl": impl}


def r1_mwf(Rxx: torch.Tensor, Rnn: torch.Tensor, mu: float = 1.0) -> torch.Tensor:
    """Rank-1 SDW-MWF (the 'r1-mwf' branch of internal_formulas.py:45-54):
    project Rxx onto its dominant eigenpair, then ``W = P[:, 0] / (mu + tr
    P)`` with ``P = Rnn^-1 Rxx_1``."""
    lam, V = torch.linalg.eigh(0.5 * (Rxx + _herm(Rxx)))
    vmax = V[..., :, -1]
    lmax = lam[..., -1].abs()
    Rxx1 = lmax[..., None, None].to(Rxx.dtype) * (vmax[..., :, None] * vmax[..., None, :].conj())
    P = torch.linalg.solve(_load_diag(Rnn), Rxx1)
    tr = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)
    return P[..., :, 0] / (mu + tr[..., None])


def mwf(Rxx: torch.Tensor, Rnn: torch.Tensor) -> torch.Tensor:
    """Plain MWF (the 'mwf' branch of internal_formulas.py:74-76):
    ``W = (Rxx + Rnn)^-1 Rxx e1``."""
    return torch.linalg.solve(_load_diag(Rxx + Rnn), Rxx)[..., :, 0]


def intern_filter(Rxx, Rnn, mu: float = 1.0, ftype: str = "r1-mwf", rank="full"):
    """The reference's ``intern_filter`` surface (internal_formulas.py:31-81)
    with its defaults (type 'r1-mwf', rank 'full').  Returns (W, t1); t1 is
    the e1 selector for the non-GEVD types, as in the reference."""
    if ftype == "gevd":
        return gevd_mwf(Rxx, Rnn, mu=mu, rank=rank)
    if ftype == "gevd-power":
        if rank != 1:
            raise ValueError("the 'gevd-power' solver is rank-1 only; pass rank=1")
        return rank1_gevd(Rxx, Rnn, mu=mu, solver="power")
    t1 = torch.zeros(Rxx.shape[:-1], dtype=Rxx.dtype, device=Rxx.device)
    t1[..., 0] = 1.0
    if ftype == "r1-mwf":
        return r1_mwf(Rxx, Rnn, mu=mu), t1
    if ftype == "mwf":
        return mwf(Rxx, Rnn), t1
    raise AttributeError("Unknown filter reference")
