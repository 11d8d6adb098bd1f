"""The port's rank-1 GEVD-MWF solvers (``disco_tpu_torch.ops.mwf_ops``,
``ops.eigh_ops``, ``beam.filters``, ``solver_spec``) against the JAX
package.

Tolerances: the plain fused solve repeats ``_mwf_kernel``'s chain in
float32, so it meets the interpret-mode Pallas kernel at 1e-5 rel-l2 (the
"xla vs pallas" bound of ``doc/source/performance.rst``) and the float64
``intern_filter_np`` oracle at 1e-3 rel-l2 (the exact-lane bound of
``tests/test_mwf_ops.py``).  The other solver families go through
``torch.linalg`` where the reference goes through XLA's linear algebra:
1e-4 rel-l2 between the two frameworks.
"""
import numpy as np
import pytest
import torch

from disco_tpu import solver_spec as jspec
from disco_tpu.beam import filters as jfilters
from disco_tpu.ops import eigh_ops as jeigh
from disco_tpu.ops import mwf_ops as jmwf
from disco_tpu.ops import resolve as jresolve
from disco_tpu_torch import solver_spec as tspec
from disco_tpu_torch.beam import filters as tfilters
from disco_tpu_torch.ops import eigh_ops as teigh
from disco_tpu_torch.ops import mwf_ops as tmwf
from disco_tpu_torch.ops import resolve as tresolve
from tests.reference_impls import intern_filter_np
from tests.torch_port_helpers import pencils, rel_l2, to_np

TOL_KERNEL, TOL_ORACLE, TOL_LINALG = 1e-5, 1e-3, 1e-4


def _c64(*arrays):
    return tuple(a.astype(np.complex64) for a in arrays)


@pytest.mark.parametrize("C", [4, 7, 11])
def test_fused_plain_matches_pallas_interpret_and_oracle(rng, C):
    """C = 4 (step 1), 11 (step 2 of the 8-node scene) and 7 (the generic
    size path of the CUDA kernel)."""
    Rss64, Rnn64 = pencils(rng, C)
    Rss, Rnn = _c64(Rss64, Rnn64)
    w, t1 = tmwf.fused_mwf_plain(torch.from_numpy(Rss), torch.from_numpy(Rnn))
    j_w, j_t1 = jmwf.fused_mwf_pallas(Rss, Rnn, tile=128, interpret=True)
    assert w.shape == t1.shape == (16, C) and w.dtype == torch.complex64
    assert rel_l2(w, j_w) <= TOL_KERNEL, rel_l2(w, j_w)
    assert rel_l2(t1, j_t1) <= TOL_KERNEL, rel_l2(t1, j_t1)
    oracle = np.stack([intern_filter_np(Rss64[f], Rnn64[f], ftype="gevd", rank=1)[0]
                       for f in range(16)])
    assert rel_l2(w, oracle) <= TOL_ORACLE, rel_l2(w, oracle)


def test_fused_per_pencil_mu_and_sweeps_match_jax(rng):
    Rss, Rnn = _c64(*pencils(rng, 5, F=8))
    mu = np.linspace(0.5, 3.0, 8).astype(np.float32)
    w, _ = tmwf.fused_mwf_plain(torch.from_numpy(Rss), torch.from_numpy(Rnn),
                                mu=torch.from_numpy(mu), sweeps=3)
    for f in range(8):
        j_w, _ = jmwf.fused_mwf_xla(Rss[f:f + 1], Rnn[f:f + 1], mu=float(mu[f]), sweeps=3)
        assert rel_l2(w[f], j_w[0]) <= TOL_KERNEL


def test_fused_sanitize_falls_back_to_e1(rng):
    """A NaN pencil: e1 under sanitize=True, non-finite under
    sanitize=False; intact pencils are untouched by the guard."""
    Rss, Rnn = _c64(*pencils(rng, 4, F=8))
    Rnn_bad = Rnn.copy()
    Rnn_bad[3] = np.nan
    S, N, Nb = (torch.from_numpy(a) for a in (Rss, Rnn, Rnn_bad))
    for impl in ("auto", "xla", "pallas"):
        w, t1 = tmwf.rank1_gevd_fused(S, Nb, impl=impl, sanitize=True)
        e1 = np.zeros(4, np.complex64)
        e1[0] = 1.0
        np.testing.assert_array_equal(to_np(w)[3], e1)
        np.testing.assert_array_equal(to_np(t1)[3], e1)
        assert np.isfinite(to_np(w)).all() and np.isfinite(to_np(t1)).all()
        w_raw, _ = tmwf.rank1_gevd_fused(S, Nb, impl=impl, sanitize=False)
        assert not np.isfinite(to_np(w_raw)[3]).all()
        w_ok, _ = tmwf.rank1_gevd_fused(S, N, impl=impl, sanitize=True)
        np.testing.assert_array_equal(to_np(w)[:3], to_np(w_ok)[:3])
        j_w, _ = jmwf.rank1_gevd_fused(Rss, Rnn_bad, impl="xla", sanitize=True)
        assert rel_l2(w, j_w) <= TOL_KERNEL


def test_eigh_jacobi_matches_jax(rng):
    A = rng.standard_normal((6, 5, 5)) + 1j * rng.standard_normal((6, 5, 5))
    A = (A @ A.conj().transpose(0, 2, 1)).astype(np.complex64)
    lam, V = teigh.eigh_jacobi(torch.from_numpy(A))
    j_lam, _ = jeigh.eigh_jacobi(A)
    assert rel_l2(lam, j_lam) <= TOL_KERNEL
    # eigenvectors up to phase: V diag(lam) V^H rebuilds A
    Vn = to_np(V).astype(np.complex128)
    back = np.einsum("bij,bj,bkj->bik", Vn, to_np(lam), Vn.conj())
    assert rel_l2(back, A) <= 1e-5
    real = np.real(A[0]).astype(np.float32)
    real = (real + real.T) / 2
    lam_r, V_r = teigh.eigh_jacobi(torch.from_numpy(real))
    assert V_r.dtype == torch.float32
    assert rel_l2(lam_r, jeigh.eigh_jacobi(real)[0]) <= TOL_KERNEL
    assert teigh._pairs(4) == jeigh._pairs(4)
    assert [teigh.default_sweeps(c) for c in range(1, 17)] == \
        [jeigh.default_sweeps(c) for c in range(1, 17)]


SOLVERS = ["eigh", "power", "power:5", "jacobi", "jacobi:3", "fused", "fused-xla",
           "fused-pallas", "fused:2"]


@pytest.mark.parametrize("solver", SOLVERS)
def test_rank1_gevd_dispatch_matches_jax(rng, solver):
    Rss, Rnn = _c64(*pencils(rng, 4, F=12))
    w, t1 = tfilters.rank1_gevd(torch.from_numpy(Rss), torch.from_numpy(Rnn), mu=1.5,
                                solver=solver)
    j_w, j_t1 = jfilters.rank1_gevd(Rss, Rnn, mu=1.5, solver=solver)
    assert rel_l2(w, j_w) <= TOL_LINALG, rel_l2(w, j_w)
    assert rel_l2(t1, j_t1) <= TOL_LINALG, rel_l2(t1, j_t1)


def test_gevd_full_rank_and_unsanitized_match_jax(rng):
    Rss, Rnn = _c64(*pencils(rng, 3, F=10))
    for kw in ({"rank": "full"}, {"rank": 2}, {"sanitize": False}):
        w, _ = tfilters.gevd_mwf(torch.from_numpy(Rss), torch.from_numpy(Rnn), **kw)
        j_w, _ = jfilters.gevd_mwf(Rss, Rnn, **kw)
        assert rel_l2(w, j_w) <= TOL_LINALG, (kw, rel_l2(w, j_w))


def test_unported_solver_lanes_raise(rng):
    """An unknown precision lane and an unknown eigensolver are refused.
    (``'jacobi-pallas'`` is ported: tests/test_torch_port_eigh.py; the bf16
    lane: tests/test_torch_port_bf16.py.)"""
    Rss, Rnn = (torch.from_numpy(a) for a in _c64(*pencils(rng, 3, F=2)))
    with pytest.raises(ValueError, match="unknown precision"):
        tfilters.rank1_gevd(Rss, Rnn, solver="fused", precision="fp8")
    with pytest.raises(ValueError, match="unknown eigh_impl"):
        tfilters.gevd_mwf(Rss, Rnn, eigh_impl="qr")


@pytest.mark.parametrize("spec", ["eigh", "power", "power:12", "jacobi:4", "jacobi-pallas",
                                  "fused", "fused-xla:3", "fused-pallas", "eigh:3",
                                  "fused-mosaic", "power:0", "jacobi:x", "fused:"])
def test_solver_spec_grammar_matches_jax(spec):
    try:
        expected = jspec.parse_solver_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tspec.parse_solver_spec(spec)
        return
    assert tspec.parse_solver_spec(spec) == expected
    assert tspec.is_fused_spec(spec) == jspec.is_fused_spec(spec)


def test_solver_tables_match_jax():
    assert tspec.RANK1_SOLVERS == jspec.RANK1_SOLVERS
    assert set(tspec.FUSED_IMPLS) == set(jspec.FUSED_IMPLS)
    assert not tspec.is_fused_spec(None)
    assert (tfilters.EIG_FLOOR, tfilters.EIG_CEIL, tfilters.DIAG_LOADING) == \
        (jfilters.EIG_FLOOR, jfilters.EIG_CEIL, jfilters.DIAG_LOADING)


def test_precision_tokens():
    assert tresolve.resolve_precision(" F32 ") == "f32"
    assert tresolve.resolve_precision(" BF16 ") == "bf16"
    assert tresolve.PRECISIONS == jresolve.PRECISIONS
    for fn in (tresolve.resolve_precision, tresolve.check_canonical_precision):
        assert fn("f32") == "f32" and fn("bf16") == "bf16"
        with pytest.raises(ValueError):
            fn("fp8")
    for token in ("F32", "BF16"):
        with pytest.raises(ValueError, match="not canonical"):
            tresolve.check_canonical_precision(token)
    assert tresolve.compute_dtype("bf16") == torch.bfloat16
    assert tresolve.compute_dtype("f32") == torch.float32


@pytest.mark.parametrize("mu", ["number", "numpy scalar", "one-element tensor", "per pencil",
                                "per pencil, strided", "per pencil, other device"])
def test_kernel_mu_argument_copies_only_what_it_must(mu):
    """The fused-solve wrapper hands the kernel one mu by value and one mu
    per pencil as a contiguous float32 array on the pencils' device, copying
    only a strided, non-float32 or elsewhere-held one."""
    per = torch.linspace(0.5, 2.0, 6 * 4).reshape(6, 4)
    arg = {"number": 1.5, "numpy scalar": np.float32(1.5),
           "one-element tensor": torch.tensor([1.5], dtype=torch.float64),
           "per pencil": per, "per pencil, strided": per.t().contiguous().t(),
           "per pencil, other device": per}[mu]
    if mu == "per pencil, other device":
        # pencils on the meta device: the host's per-pencil mu is moved there
        tensor, stride, value = tmwf._mu_argument(arg, (6, 4), torch.device("meta"))
        assert tensor.device.type == "meta" and tensor.dtype == torch.float32
        assert stride == 1 and tensor.is_contiguous() and tensor.shape == (24,)
        return
    tensor, stride, value = tmwf._mu_argument(arg, (6, 4), torch.device("cpu"))
    if mu in ("number", "numpy scalar", "one-element tensor"):
        assert tensor is None and stride == 0 and value == 1.5
        return
    assert stride == 1 and tensor.is_contiguous() and tensor.shape == (24,)
    assert torch.equal(tensor, per.reshape(-1))
    assert (tensor.data_ptr() == per.data_ptr()) == (mu == "per pencil")
