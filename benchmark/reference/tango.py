"""The plain two-step TANGO pipeline (Furnon et al., TASLP 2021; nfurnon/disco
``speech_enhancement/tango.py:252-457``, ``se_utils/internal_formulas.py``)
in the dtype of its inputs: ideal ratio masks, frame-mean masked covariances,
the rank-1 GEVD multichannel Wiener filter, the exchange of one compressed
signal a node, and the global filter of step 2 (the 'local' mask policy).

The filter follows the formula of ``internal_formulas.py``: the dominant
generalized eigenpair of (Rss, Rnn), its eigenvalue clipped to [eps, 1e6],
``w = q1 lam / (lam + mu) (Q^-1)[0, 0]``.  It is computed by Cholesky
whitening and a Hermitian eigensolve (``torch.linalg.eigh``), after the
scale normalization and the relative diagonal loading of 1e-6 of the mean
noise power that the deployed filter states; a non-finite filter falls back
to the reference-mic selector.  ``solver='power'`` replaces the eigensolve
by 12 power iterations from the uniform vector: the corpus driver makes the
step-2 CRNN's input with that solver (``enhance/driver.py::_batched_masks``),
so a reference of that output has to take the same iterate.
"""
from __future__ import annotations

import torch

EPS64 = 2.220446049250313e-16
EIG_CEIL = 1e6
LOADING = 1e-6
EIGH_CHUNK = 8192


def irm1(S: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """The ideal ratio mask |S| / (|S| + |N|), |N| floored at float64 eps."""
    xi = S.abs() / N.abs().clamp_min(EPS64)
    return xi / (1.0 + xi)


def covariance(X: torch.Tensor) -> torch.Tensor:
    """(..., D, F, T) -> (..., F, D, D): ``mean_t X X^H``."""
    return torch.einsum("...cft,...dft->...fcd", X, X.conj()) / X.shape[-1]


def _herm(A):
    return A.conj().transpose(-1, -2)


def _eigh_top(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The largest eigenvalue and its vector of Hermitian ``A`` (..., C, C),
    in chunks of matrices."""
    C = A.shape[-1]
    flat = A.reshape(-1, C, C)
    lam, vec = [], []
    for part in flat.split(EIGH_CHUNK):
        w, U = torch.linalg.eigh(part)
        lam.append(w[:, -1])
        vec.append(U[:, :, -1])
    return (torch.cat(lam).reshape(A.shape[:-2]), torch.cat(vec).reshape(A.shape[:-1]))


def _power_top(A: torch.Tensor, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` power iterations from the uniform unit vector, and the
    Rayleigh quotient of the last iterate."""
    C = A.shape[-1]
    tiny = torch.finfo(A.real.dtype).tiny
    v = torch.full(A.shape[:-1], C ** -0.5, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        w = (A @ v[..., None])[..., 0]
        v = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(tiny)
    lam = (v.conj()[..., None, :] @ A @ v[..., None])[..., 0, 0].real
    return lam, v


def gevd_rank1(Rss: torch.Tensor, Rnn: torch.Tensor, mu: float = 1.0, solver: str = "eigh",
               iters: int = 12) -> torch.Tensor:
    """(..., F, C, C) pencils -> (..., F, C) rank-1 GEVD-MWF filters."""
    C = Rss.shape[-1]
    real = Rss.real.dtype
    tr = torch.diagonal(Rnn, dim1=-2, dim2=-1).real.sum(-1)[..., None, None] / C
    scale = 1.0 / tr.clamp_min(torch.finfo(real).smallest_normal)
    Rss, Rnn = Rss * scale, Rnn * scale
    eye = torch.eye(C, dtype=Rss.dtype, device=Rss.device)
    tr_n = torch.diagonal(Rnn, dim1=-2, dim2=-1).real.sum(-1)[..., None, None] / C
    Rnn = Rnn + (LOADING * tr_n + torch.finfo(real).tiny) * eye
    L, info = torch.linalg.cholesky_ex(Rnn)
    L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
    B = torch.linalg.solve_triangular(L, Rss, upper=False)
    A = _herm(torch.linalg.solve_triangular(L, _herm(B), upper=False))
    A = 0.5 * (A + _herm(A))
    bad = ~torch.isfinite(torch.view_as_real(A)).flatten(-3).all(-1)
    A = torch.where(bad[..., None, None], eye, A)
    lam, u = _eigh_top(A) if solver == "eigh" else _power_top(A, iters)
    lam = lam.clamp(EPS64, EIG_CEIL)
    q1 = torch.linalg.solve_triangular(_herm(L), u[..., None], upper=True)[..., 0]
    qinv = (u[..., 0] * L[..., 0, 0]).conj()
    w = q1 * ((lam / (lam + mu)).to(q1.dtype) * qinv)[..., None]
    e1 = torch.zeros_like(w)
    e1[..., 0] = 1.0
    ok = torch.isfinite(torch.view_as_real(w)).flatten(-2).all(-1) & ~bad
    return torch.where(ok[..., None], w, e1)


def apply(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``sum_c conj(w[..., f, c]) X[..., c, f, t]``."""
    return torch.einsum("...fc,...cft->...ft", w.conj(), X)


def step1(Y: torch.Tensor, mask: torch.Tensor, mu: float = 1.0, solver: str = "eigh"):
    """Each node's local filter on its own mics: (..., K, C, F, T) and
    (..., K, F, T) masks -> the compressed signal z (..., K, F, T)."""
    m = mask[..., None, :, :]
    w = gevd_rank1(covariance(m * Y), covariance((1.0 - m) * Y), mu, solver)
    return apply(w, Y)


def others(K: int) -> list[list[int]]:
    """Row k: the nodes j != k in ascending order (tango.py:142-155)."""
    return [[j for j in range(K) if j != k] for k in range(K)]


def step2(Y: torch.Tensor, z: torch.Tensor, mask: torch.Tensor, mu: float = 1.0):
    """Each node's global filter on ``[y_k || z_j, j != k]`` with its own
    mask on every channel: -> (..., K, F, T) enhanced spectra."""
    K = Y.shape[-4]
    idx = torch.tensor(others(K), device=Y.device)
    X = torch.cat([Y, z[..., idx, :, :]], dim=-3)                          # (..., K, D, F, T)
    m = mask[..., None, :, :]
    w = gevd_rank1(covariance(m * X), covariance((1.0 - m) * X), mu)
    return apply(w, X)


def tango(Y: torch.Tensor, mask_z: torch.Tensor, mask_w: torch.Tensor, mu: float = 1.0):
    """Both steps: (..., K, C, F, T) spectra and masks -> (..., K, F, T)."""
    return step2(Y, step1(Y, mask_z, mu), mask_w, mu)
