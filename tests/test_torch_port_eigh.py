"""The port's Jacobi eigensolver lane (``disco_tpu_torch.ops.eigh_ops``:
the plain version of the ``csrc/eigh.cu`` kernel and the
``'jacobi-pallas'`` seam) against the JAX package's ``eigh_jacobi_pallas``
in interpret mode and ``eigh_jacobi``, on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 on eigenvalues and eigenvectors, the bound
of ``tests/test_eigh_ops.py::test_pallas_interpret_matches_xla`` for the
same schedule compiled two ways (the random matrices have well separated
eigenvalues, so the eigenvectors are compared as they come, phase
included: both sides run the same rotations).  The GEVD filters built on
the lane go through ``torch.linalg`` where the reference goes through
XLA: 1e-4 rel-l2, as in ``tests/test_torch_port_mwf.py``.
"""
import numpy as np
import pytest
import torch

from disco_tpu.beam import filters as jfilters
from disco_tpu.ops import eigh_ops as jeigh
from disco_tpu_torch.beam import filters as tfilters
from disco_tpu_torch.ops import eigh_ops as teigh
from tests.torch_port_helpers import pencils, rel_l2, to_np

TOL, TOL_LINALG = 1e-5, 1e-4


def _hermitian(rng, B, C, complex_):
    X = rng.standard_normal((B, C, C))
    if complex_:
        X = X + 1j * rng.standard_normal((B, C, C))
    A = X @ np.conj(np.swapaxes(X, -1, -2))
    return A.astype(np.complex64 if complex_ else np.float32)


#: (C, complex, B): C = 4 (the step-1 width) in both types and at both
#: batch sizes, C = 7 (the kernel's generic path) once; B = 130 leaves a
#: ragged second tile of the JAX kernel's 128-matrix tiles, and matrix 3
#: of it is all NaN.  (Each shape is a fresh interpret-mode compile of
#: ~4 s at C = 4 and ~25 s at C = 7 on a CPU.)
CASES = [(4, True, 5), (4, True, 130), (4, False, 5), (4, False, 130), (7, True, 130)]


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(0)
    out = {}
    for C, complex_, B in CASES:
        A = _hermitian(rng, B, C, complex_)
        if B == 130:
            A[3] = np.nan
        out[C, complex_, B] = A
    return out


@pytest.mark.parametrize("C,complex_,B", CASES)
def test_jacobi_lane_matches_jax(cases, C, complex_, B):
    """Against the interpret-mode Pallas kernel, and at C = 4 against the
    XLA formulation too."""
    A = cases[C, complex_, B]
    lam, V = teigh.eigh_jacobi_pallas(torch.from_numpy(A))
    refs = [jeigh.eigh_jacobi_pallas(A, tile=128, interpret=True)]
    if C == 4:
        refs.append(jeigh.eigh_jacobi(A))
    assert lam.dtype == torch.float32
    assert V.dtype == (torch.complex64 if complex_ else torch.float32)
    assert lam.shape == (B, C) and V.shape == (B, C, C)
    ok = np.isfinite(A).reshape(B, -1).all(-1)
    for ref_lam, ref_V in refs:
        np.testing.assert_allclose(to_np(lam)[ok], np.asarray(ref_lam)[ok], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to_np(V)[ok], np.asarray(ref_V)[ok], rtol=TOL, atol=TOL)
        # a NaN matrix gives NaN eigenvalues and eigenvectors on both sides
        assert np.isnan(to_np(lam)[~ok]).all() and np.isnan(np.asarray(ref_lam)[~ok]).all()
        assert np.isnan(to_np(V)[~ok]).all() and np.isnan(np.asarray(ref_V)[~ok]).all()
    # on a CPU tensor the seam is the plain eigensolve, bit for bit
    p_lam, p_V = teigh.eigh_jacobi(torch.from_numpy(A))
    assert torch.equal(lam.nan_to_num(), p_lam.nan_to_num())
    assert torch.equal(V.nan_to_num(), p_V.nan_to_num())


def test_kernel_wrapper_is_unsorted_plain_on_cpu(cases):
    """The wrapper returns the kernel's outputs — the unsorted diagonal and
    V — which the seam sorts; an explicit sweep count reaches both sides."""
    A = torch.from_numpy(cases[4, True, 5])
    before = teigh.eigh_jacobi_kernel.launches
    d, V = teigh.eigh_jacobi_kernel(A, sweeps=3)
    assert teigh.eigh_jacobi_kernel.launches == before  # CPU: the plain version
    u_d, u_V = teigh.eigh_jacobi_unsorted(A, sweeps=3)
    assert torch.equal(d, u_d) and torch.equal(V, u_V)
    order = torch.argsort(d, dim=-1, stable=True)
    lam, V_sorted = teigh.eigh_jacobi_pallas(A, sweeps=3)
    assert torch.equal(lam, torch.take_along_dim(d, order, dim=-1))
    assert torch.equal(V_sorted, torch.take_along_dim(V, order[:, None, :].expand_as(V), dim=-1))
    j_lam, j_V = jeigh.eigh_jacobi_pallas(cases[4, True, 5], sweeps=3, tile=128, interpret=True)
    np.testing.assert_allclose(to_np(lam), np.asarray(j_lam), rtol=TOL, atol=TOL)


def test_sort_is_stable_and_puts_nan_last():
    lam = torch.tensor([[2.0, float("nan"), 1.0, 1.0]])
    V = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4)
    s_lam, s_V = teigh._sort_eigpairs(lam, V)
    assert s_lam[0, :3].tolist() == [1.0, 1.0, 2.0] and torch.isnan(s_lam[0, 3])
    assert s_V[0, 0].tolist() == [2.0, 3.0, 0.0, 1.0]


def test_kernel_wrapper_takes_only_cpu_or_cuda_tensors():
    """A tensor on any other device raises; it never reaches a plain
    version."""
    with pytest.raises(ValueError, match="unsupported device"):
        teigh.eigh_jacobi_kernel(torch.zeros(2, 3, 3, device="meta"))


@pytest.mark.parametrize("solver", ["jacobi-pallas", "jacobi-pallas:3"])
def test_rank1_gevd_jacobi_pallas_matches_jax(solver):
    rng = np.random.default_rng(1)
    Rss, Rnn = (a.astype(np.complex64) for a in pencils(rng, 4, F=12))
    w, t1 = tfilters.rank1_gevd(torch.from_numpy(Rss), torch.from_numpy(Rnn), mu=1.5,
                                solver=solver)
    j_w, j_t1 = jfilters.rank1_gevd(Rss, Rnn, mu=1.5, solver=solver)
    assert rel_l2(w, j_w) <= TOL_LINALG, rel_l2(w, j_w)
    assert rel_l2(t1, j_t1) <= TOL_LINALG, rel_l2(t1, j_t1)


def test_gevd_mwf_jacobi_pallas_matches_jax():
    """Full rank, rank 2 and unsanitized filters through the
    'jacobi-pallas' eigensolve, and a NaN pencil left non-finite under
    sanitize=False (the streaming ffill guard needs it)."""
    rng = np.random.default_rng(2)
    Rss, Rnn = (a.astype(np.complex64) for a in pencils(rng, 4, F=10))
    Rnn[4] = np.nan
    ok = np.arange(10) != 4
    for kw in ({"rank": "full"}, {"rank": 2}, {"sanitize": False}):
        w, _ = tfilters.gevd_mwf(torch.from_numpy(Rss), torch.from_numpy(Rnn),
                                 eigh_impl="jacobi-pallas", **kw)
        j_w, _ = jfilters.gevd_mwf(Rss, Rnn, eigh_impl="jacobi-pallas", **kw)
        assert rel_l2(to_np(w)[ok], np.asarray(j_w)[ok]) <= TOL_LINALG, kw
        if kw.get("sanitize") is False:
            assert not np.isfinite(to_np(w)[4]).all()
